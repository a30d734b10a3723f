"""Dense XIC extraction by slab gather and prefix sums (plain PyTorch).

The plain version of the CUDA kernel in ``ops/xic_cuda.py``: the CPU path
runs it, and the card's checks hold the kernel against it.

The peak store is sorted by (slot, coarse m/z bin, cycle, m/z) with a
per-cell offset index, so one XIC query (slot, query m/z +- ppm, cycle
window [c0, c0+W)) reads ONE contiguous slab of at most ``slab`` peaks.
Per-cycle intensities fall out of prefix sums sliced at the per-cycle cell
boundaries:

    boundaries r[w] = cell_start[slot, bin, c0+w]          (W+1 values)
    slab       = peaks[r[0] : r[0]+slab]                   (one gather run)
    v          = intensity * (mz within +-ppm)             (mask)
    P          = exclusive cumsum(v)
    XIC[w]     = P[r[w+1]-r[0]] - P[r[w]-r[0]]

The prefix sums run in float64: a difference of two float32 prefix sums
near the end of a full slab loses the low bits of a small cell, while the
kernel sums each cell directly. Observed m/z is the intensity-weighted mean
of the matched peaks.
"""

from __future__ import annotations

import numpy as np
import torch


def query_bounds(query_mz, tol_ppm):
    """``(q_lo, q_hi)`` = query m/z * (1 -+ ppm * 1e-6), in float32 steps."""
    tol = np.float32(tol_ppm) * np.float32(1e-6)
    return query_mz * float(np.float32(1.0) - tol), query_mz * float(np.float32(1.0) + tol)


def query_rows(slot_idx, query_mz, *, n_slots, n_bins, bin_mz_min, bin_width):
    """Row of ``cell_start`` viewed as [n_slots * n_bins, L] for each query:
    the query's slot and the coarse bin of its m/z centre (int64)."""
    slot_c = slot_idx.long().clamp(0, n_slots - 1)
    b_c = (
        torch.floor((query_mz - float(np.float32(bin_mz_min))) / float(np.float32(bin_width)))
        .long()
        .clamp(0, n_bins - 1)
    )
    return slot_c * n_bins + b_c


def extract_xic(
    peak_mz: torch.Tensor,  # f32[N]
    peak_intensity: torch.Tensor,  # f32[N]
    cell_start: torch.Tensor,  # i32[n_slots, n_bins, n_cycles+1]
    slot_idx: torch.Tensor,  # i32[B, Q] (-1 = masked query)
    query_mz: torch.Tensor,  # f32[B, Q]
    tol_ppm: float,
    cycle_start: torch.Tensor,  # i32[B]
    *,
    n_cycles: int,
    n_bins: int,
    bin_mz_min: float,
    bin_width: float,
    slab: int = 256,
    window_len: int = 64,
    with_mz: bool = False,
    mz_as_delta: bool = False,
    peak_scanbin: torch.Tensor | None = None,  # i32[N]
    scan_lo: torch.Tensor | None = None,  # i32[B]
    scan_hi: torch.Tensor | None = None,  # i32[B], exclusive
):
    """Dense XICs: intensity f32[B, Q, W] and, with ``with_mz``, the observed
    m/z f32[B, Q, W] (0 where empty), or with ``mz_as_delta`` the
    (observed - query) m/z delta."""
    B, Q = slot_idx.shape
    W = window_len
    n_slots = cell_start.shape[0]
    L = cell_start.shape[2]  # cycle axis may be bucket-padded
    dev = slot_idx.device

    valid_q = slot_idx >= 0
    q_lo, q_hi = query_bounds(query_mz, tol_ppm)
    row = query_rows(
        slot_idx, query_mz, n_slots=n_slots, n_bins=n_bins,
        bin_mz_min=bin_mz_min, bin_width=bin_width,
    )
    w_idx = torch.arange(W + 1, device=dev)
    cyc = (cycle_start.long()[:, None, None] + w_idx).clamp(0, n_cycles)  # [B, 1, W+1]
    r = cell_start.reshape(-1)[row[:, :, None] * L + cyc].long()  # [B, Q, W+1]

    slab_start = r[:, :, :1]
    rel = (r - slab_start).clamp(0, slab)  # [B, Q, W+1]
    slab_len = rel[:, :, -1:]
    k = torch.arange(slab, device=dev)
    g_idx = (slab_start + k).clamp(0, peak_mz.shape[0] - 1)  # [B, Q, slab]
    g_mz = peak_mz[g_idx]
    g_int = peak_intensity[g_idx]
    vmask = (
        (k < slab_len)
        & (g_mz >= q_lo[:, :, None])
        & (g_mz <= q_hi[:, :, None])
        & valid_q[:, :, None]
    )
    if peak_scanbin is not None:
        g_scan = peak_scanbin[g_idx]
        vmask &= (g_scan >= scan_lo[:, None, None]) & (g_scan < scan_hi[:, None, None])

    def cell_sums(v):
        P = torch.nn.functional.pad(torch.cumsum(v.double(), dim=-1), (1, 0))
        Pr = torch.gather(P, -1, rel)
        return (Pr[:, :, 1:] - Pr[:, :, :-1]).float()

    intensity = cell_sums(torch.where(vmask, g_int, 0.0))
    if not with_mz:
        return intensity
    # m/z relative to the query centre keeps the sums small
    qc = (q_lo + q_hi) * 0.5
    dmz_sum = cell_sums(torch.where(vmask, g_int * (g_mz - qc[:, :, None]), 0.0))
    dmz = torch.where(intensity > 0, dmz_sum / intensity.clamp(min=1e-12), 0.0)
    if mz_as_delta:
        return intensity, dmz
    return intensity, torch.where(intensity > 0, qc[:, :, None] + dmz, 0.0)


def extract_xic_packed(
    peak_packed: torch.Tensor,  # f32[N, 4] (mz, intensity, cycle, scanbin)
    cell_start: torch.Tensor,
    slot_idx: torch.Tensor,
    query_mz: torch.Tensor,
    tol_ppm: float,
    cycle_start: torch.Tensor,
    *,
    cycle_stride: int = 1,
    scan_lo: torch.Tensor | None = None,
    scan_hi: torch.Tensor | None = None,
    **kw,
):
    """``extract_xic`` with the CUDA kernel's signature: the packed store,
    ``cycle_stride`` and the scan window. A coarse view's strided
    ``cell_start`` already merges ``cycle_stride`` cycles into one cell, so
    the plain version needs no stride."""
    del cycle_stride
    scan_kw = {}
    if scan_lo is not None:
        scan_kw = dict(
            peak_scanbin=peak_packed[:, 3].to(torch.int32), scan_lo=scan_lo, scan_hi=scan_hi
        )
    return extract_xic(
        peak_packed[:, 0], peak_packed[:, 1], cell_start, slot_idx, query_mz,
        tol_ppm, cycle_start, **kw, **scan_kw,
    )
