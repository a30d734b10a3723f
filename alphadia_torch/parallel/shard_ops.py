"""The XIC kernel on each device's shard of a batch.

The JAX package wraps its Pallas XIC kernel in ``shard_map``: every device
runs the kernel on its slice of the query batch against its replicated
copy of the peak store. Here the same kernel (``ops/xic_cuda``) is launched
once per device, each launch under its own device (the current device and
stream of the shard's card), and the outputs are gathered in row order.
XIC extraction is independent per query, so the sharded result equals the
unsharded one exactly. On CPU tensors each shard runs the kernel's plain
version.

``run_on_devices`` is the route itself: the drivers' mesh branches
(``search/selection``, ``search/scoring``) run a whole selection or scoring
op on each device's shard through it, and the XIC kernel launches inside
those ops. ``launches`` counts the kernel launches made through the route
over two devices or more.
"""

from __future__ import annotations

import torch

from alphadia_torch.ops import xic_cuda
from alphadia_torch.parallel.mesh import device_guard, gather_rows, shard_bounds

launches = 0  # XIC kernel launches made through the route over several devices (or since a caller reset it)


def run_on_devices(devices: list, fn) -> list:
    """``[fn(i, devices[i]) for each device]``, each call under its own
    device; launches on distinct cards overlap (nothing here waits)."""
    global launches
    out = []
    for i, device in enumerate(devices):
        before = xic_cuda.launches
        with device_guard(torch.device(device)):
            out.append(fn(i, torch.device(device)))
        if len(devices) > 1:
            launches += xic_cuda.launches - before
    return out


def extract_xic_cuda_sharded(
    devices: list,
    stores: list,  # one PeakStore per device (DiaData.device_arrays(stride, device))
    cell_starts: list,  # one i32[n_slots, n_bins, n_cycles+1] per device
    slot_idx: torch.Tensor,  # i32[B, Q], B divisible by len(devices)
    query_mz: torch.Tensor,  # f32[B, Q]
    tol_ppm: float,
    cycle_start: torch.Tensor,  # i32[B]
    *,
    scan_lo: torch.Tensor | None = None,  # i32[B]
    scan_hi: torch.Tensor | None = None,  # i32[B], exclusive
    **kw,
):
    """Batch-sharded XIC: the query rows cut into ``len(devices)`` equal
    shards, shard i extracted on ``devices[i]`` from ``stores[i]``; returns
    ``[B, Q, W]`` (and the m/z plane with ``with_mz``) on ``devices[0]``,
    in row order. ``kw`` as for ``xic_cuda.extract_xic_cuda``."""
    if not (len(devices) == len(stores) == len(cell_starts)):
        raise ValueError("one store and one cell index per device")
    bounds = shard_bounds(slot_idx.shape[0], len(devices))
    row_args = {"slot_idx": slot_idx, "query_mz": query_mz, "cycle_start": cycle_start}
    if scan_lo is not None:
        row_args.update(scan_lo=scan_lo, scan_hi=scan_hi)

    def shard(i, device):
        lo, hi = bounds[i]
        a = {k: v[lo:hi].to(device, non_blocking=True) for k, v in row_args.items()}
        return xic_cuda.extract_xic_cuda(
            stores[i], cell_starts[i], a.pop("slot_idx"), a.pop("query_mz"), tol_ppm, a.pop("cycle_start"),
            **a, **kw,
        )

    parts = run_on_devices(devices, shard)
    first = torch.device(devices[0])
    if kw.get("with_mz"):
        return gather_rows([p[0] for p in parts], first), gather_rows([p[1] for p in parts], first)
    return gather_rows(parts, first)
