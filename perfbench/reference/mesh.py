# Frozen copy of alphadia_torch/parallel/mesh.py, lines 1-61, at commit b5dd55e, imports
# rewritten to this package; the plain reference of the benchmark. Edits below
# the copy are marked "reference:".
"""Device lists and row shards: the data-parallel layout of the port.

The JAX package lays a one-axis device mesh over its chips, shards the
precursor (candidate) axis of a batch over it and replicates the peak
store. Here the mesh is a plain list of ``torch.device``s, a batch is cut
into equal contiguous row shards, one per device (``shard_bounds``; the
drivers pad it with ``pad_to_multiple``), and the shards' outputs come back
in row order (``gather_rows``); every device holds its own copy of what
is replicated. A device may
appear more than once (``[cuda:0, cuda:0]``, ``["cpu", "cpu"]``): its
shards then run one after the other on it.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch


def make_mesh(n_devices: int | None = None, devices=None) -> list[torch.device]:
    """The first ``n_devices`` of ``devices`` (default: this process's local
    cards, ``distributed.local_devices``) as ``torch.device``s."""
    if devices is None:  # reference: always given a device list
        raise ValueError("the reference takes its devices from the caller")
    devices = [torch.device(d) for d in devices]
    return devices[: n_devices or len(devices)]


def device_guard(device: torch.device):
    """Make ``device`` the current CUDA device for the block (a kernel
    launch, an event, a stream lookup); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def shard_bounds(n_rows: int, n_shards: int) -> list[tuple[int, int]]:
    """``[start, stop)`` of ``n_shards`` equal contiguous row shards."""
    if n_rows % n_shards:
        raise ValueError(f"{n_rows} rows do not split into {n_shards} equal shards")
    size = n_rows // n_shards
    return [(i * size, (i + 1) * size) for i in range(n_shards)]


def gather_rows(shards: list[torch.Tensor], device=None) -> torch.Tensor:
    """The shards concatenated in row order on ``device`` (default: the
    first shard's)."""
    device = shards[0].device if device is None else torch.device(device)
    return torch.cat([s.to(device, non_blocking=True) for s in shards])


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - n)
    return np.pad(arr, pad)


# reference: ``parallel/shard_ops.run_on_devices`` (same commit), one device at a time
def run_on_devices(devices: list, fn) -> list:
    """``[fn(i, devices[i]) for each device]``, each call under its own device."""
    out = []
    for i, device in enumerate(devices):
        with device_guard(torch.device(device)):
            out.append(fn(i, torch.device(device)))
    return out
