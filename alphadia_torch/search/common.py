"""Policy helpers shared by the selection and scoring drivers.

Both stages must pick the same observation slots and the same top-k
fragment subset, so these live in one place.
"""

from __future__ import annotations

import numpy as np
import torch


def kernel_available() -> bool:
    """Whether the CUDA XIC kernel can run here: a card and nvcc."""
    if not torch.cuda.is_available():
        return False
    from alphadia_torch.ops.xic_cuda import _nvcc

    try:
        _nvcc()
    except RuntimeError:
        return False
    return True


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a host array without waiting: on the card through a pinned
    buffer and a ``non_blocking`` copy (a copy from pageable memory would
    wait for the stream); on the CPU a plain tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_host_async(tensors: dict) -> tuple[dict, torch.cuda.Event | None]:
    """Start the copy of each tensor to the host without waiting for it: on
    the card into pinned buffers with ``non_blocking`` copies, then an event
    on the current stream; CPU tensors are returned as they are. Read the
    buffers through :func:`host_arrays` only."""
    if next(iter(tensors.values())).device.type != "cuda":
        return tensors, None
    out = {}
    for k, t in tensors.items():
        out[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out[k].copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return out, event


def host_arrays(pending: tuple[dict, torch.cuda.Event | None]) -> dict:
    """Wait for the copies that :func:`to_host_async` started (only those)
    and return them as numpy arrays."""
    tensors, event = pending
    if event is not None:
        event.synchronize()
    return {k: v.numpy() for k, v in tensors.items()}


def first_k_true(mask: np.ndarray, k: int) -> np.ndarray:
    """Indices of the first k true columns per row; -1 where fewer."""
    order = np.argsort(~mask, axis=1, kind="stable")[:, :k]
    has = np.take_along_axis(mask, order, axis=1)
    return np.where(has, order.astype(np.int32), -1)


def top_k_fragment_order(valid: np.ndarray, intensity: np.ndarray, k: int):
    """Column order selecting the top-k fragments by intensity (stable
    descending: the first occurrence wins ties)."""
    return np.argsort(-np.where(valid, intensity, -1.0), axis=1, kind="stable")[:, :k]


def assign_observation_slots(
    dia, mono_mz: np.ndarray, iso_mz: np.ndarray, max_ms2_obs: int, max_ms1_obs: int
):
    """Cycle-slot assignment per precursor.

    Returns ``(ms2_slots [n, O2], ms1_slots [n, O1], win_lo, win_hi)``: MS2
    slots whose isolation window overlaps the isotope envelope (first k in
    cycle order, -1 padded, with the matched window bounds), and the first
    ``max_ms1_obs`` MS1 slots per row (one column of -1 without MS1).
    Trailing MS2 columns that no precursor uses are trimmed: they would
    only add empty queries.
    """
    n = len(mono_mz)
    win_lo_all = dia.cycle[0, :, 0, 0].astype(np.float32)
    win_hi_all = dia.cycle[0, :, 0, 1].astype(np.float32)
    is_ms2 = win_lo_all >= 0
    match2 = (
        is_ms2[None, :]
        & (win_hi_all[None, :] > mono_mz[:, None])
        & (win_lo_all[None, :] < iso_mz[:, -1][:, None])
    )
    ms2_slots = first_k_true(match2, max_ms2_obs)
    slot_safe = np.clip(ms2_slots, 0, len(win_lo_all) - 1)
    win_lo = np.where(ms2_slots >= 0, win_lo_all[slot_safe], 1e7).astype(np.float32)
    win_hi = np.where(ms2_slots >= 0, win_hi_all[slot_safe], 1e7 + 1).astype(np.float32)
    if ms2_slots.shape[1] > 1:
        used = (ms2_slots >= 0).any(axis=0)
        o2_eff = int(used.nonzero()[0].max() + 1) if used.any() else 1
        ms2_slots = ms2_slots[:, :o2_eff]
        win_lo = win_lo[:, :o2_eff]
        win_hi = win_hi[:, :o2_eff]

    ms1_all = np.nonzero(~is_ms2)[0][:max_ms1_obs]
    if dia.has_ms1 and len(ms1_all):
        ms1_slots = np.broadcast_to(ms1_all.astype(np.int32), (n, len(ms1_all))).copy()
    else:
        ms1_slots = np.full((n, 1), -1, np.int32)
    return ms2_slots.astype(np.int32), ms1_slots, win_lo, win_hi
