"""Peak stores placed behind filler rows, so that their cell offsets lie
past a given row (past 2**31 for the int64 cell index) without a run of
that size: the checks of the XIC kernel's int64 instantiation and of the
plain versions at such offsets.
"""

from __future__ import annotations

import torch

from alphadia_torch.rawdata.diadata import PeakStore


def behind_filler(stores, filler: int) -> tuple[PeakStore, list[int]]:
    """One ``PeakStore`` on the stores' device: ``filler`` rows that match no
    query (m/z +inf, intensity 0), then each of ``stores`` in turn, made
    there with ``torch.full`` (on the card the host holds nothing of it).
    Returns it and each store's first row: a store's ``cell_start`` widened
    to int64 plus its first row indexes the same peaks in it."""
    dev = stores[0].packed.device
    rows = filler + sum(st.packed.shape[0] for st in stores)
    packed = torch.full((rows, 2), float("inf"), dtype=torch.float32, device=dev)
    packed[:, 1] = 0.0
    cycle = torch.full((rows,), 0, dtype=torch.int16, device=dev)  # u16 viewed as i16
    scanbin = torch.full((rows,), 0, dtype=torch.int16, device=dev)
    first, at = [], filler
    for st in stores:
        n = st.packed.shape[0]
        packed[at:at + n] = st.packed
        cycle[at:at + n] = st.cycle.view(torch.int16)
        scanbin[at:at + n] = st.scanbin
        first.append(at)
        at += n
    return PeakStore(packed, cycle.view(torch.uint16), scanbin), first
