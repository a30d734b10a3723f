"""Dense XIC extraction by slab gather and prefix sums (plain PyTorch).

``extract_xic`` is the plain version of the CUDA kernel in
``ops/xic_cuda.py``: the CPU path runs it, and the card's checks hold the
kernel against it. ``extract_xic_4d`` and ``extract_scan_profile`` (the 4D
path's XICs resolved per mobility scan bin) are plain PyTorch on every
device.

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


def _slab_reads(
    peak_mz, peak_intensity, cell_start, slot_idx, query_mz, tol_ppm, cyc, *,
    n_bins, bin_mz_min, bin_width, slab,
):
    """What the slab read of each query sees. ``cyc`` i64[B, 1, L] holds the
    cycle boundaries to look up (already clamped to [0, n_cycles]). The
    offsets are widened to int64 right after their gather, so an int32 and
    an int64 ``cell_start`` read the same peaks.

    Returns ``rel`` i64[B, Q, L], the boundaries' offsets from the slab start
    clamped to [0, slab]; the slab's peak indices i64[B, Q, slab]; their m/z
    and intensity; the mask of slab peaks inside the ppm window of a valid
    query; and the query centres."""
    L = cell_start.shape[2]  # cycle axis may be bucket-padded
    q_lo, q_hi = query_bounds(query_mz, tol_ppm)
    row = query_rows(
        slot_idx, query_mz, n_slots=cell_start.shape[0], n_bins=n_bins,
        bin_mz_min=bin_mz_min, bin_width=bin_width,
    )
    r = cell_start.reshape(-1)[row[:, :, None] * L + cyc].long()  # [B, Q, L]
    slab_start = r[:, :, :1]
    rel = (r - slab_start).clamp(0, slab)
    k = torch.arange(slab, device=slot_idx.device)
    g_idx = (slab_start + k).clamp(0, peak_mz.shape[0] - 1)  # [B, Q, slab]
    g_mz = peak_mz[g_idx]
    g_int = peak_intensity[g_idx]
    vmask = (
        (k < rel[:, :, -1:])
        & (g_mz >= q_lo[:, :, None])
        & (g_mz <= q_hi[:, :, None])
        & (slot_idx >= 0)[:, :, None]
    )
    return rel, g_idx, g_mz, g_int, vmask, (q_lo + q_hi) * 0.5


def _cell_sums(v, rel):
    """Sums of the slab values v [B, Q, slab, ...] between consecutive
    offsets rel [B, Q, L]: f32[B, Q, L-1, ...], differences of float64
    prefix sums (deterministic: no scatter of floats)."""
    P = torch.cumsum(v, dim=2, dtype=torch.float64)  # inclusive
    extra = (1,) * (v.dim() - 3)
    at = (rel - 1).clamp(min=0).reshape(rel.shape + extra).expand(*rel.shape, *v.shape[3:])
    Pr = torch.where((rel > 0).reshape(rel.shape + extra), torch.gather(P, 2, at), 0.0)
    return (Pr[:, :, 1:] - Pr[:, :, :-1]).float()


def extract_xic(
    peak_mz: torch.Tensor,  # f32[N]
    peak_intensity: torch.Tensor,  # f32[N]
    cell_start: torch.Tensor,  # i32 or i64[n_slots, n_bins, n_cycles+1]
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
    peak_scanbin: torch.Tensor | None = None,  # i16[N]
    scan_lo: torch.Tensor | None = None,  # i32[B]
    scan_hi: torch.Tensor | None = None,  # i32[B], exclusive
):
    """Dense XICs: intensity f32[B, Q, W] and, with ``with_mz``, the observed
    m/z f32[B, Q, W] (0 where empty), or with ``mz_as_delta`` the
    (observed - query) m/z delta."""
    W = window_len
    cyc = (cycle_start.long()[:, None, None] + torch.arange(W + 1, device=slot_idx.device)).clamp(0, n_cycles)
    rel, g_idx, g_mz, g_int, vmask, qc = _slab_reads(
        peak_mz, peak_intensity, cell_start, slot_idx, query_mz, tol_ppm, cyc,
        n_bins=n_bins, bin_mz_min=bin_mz_min, bin_width=bin_width, slab=slab,
    )
    if peak_scanbin is not None:
        g_scan = peak_scanbin[g_idx]
        vmask &= (g_scan >= scan_lo[:, None, None]) & (g_scan < scan_hi[:, None, None])

    intensity = _cell_sums(torch.where(vmask, g_int, 0.0), rel)
    if not with_mz:
        return intensity
    # m/z relative to the query centre keeps the sums small
    dmz_sum = _cell_sums(torch.where(vmask, g_int * (g_mz - qc[:, :, None]), 0.0), rel)
    dmz = torch.where(intensity > 0, dmz_sum / intensity.clamp(min=1e-12), 0.0)
    if mz_as_delta:
        return intensity, dmz
    return intensity, torch.where(intensity > 0, qc[:, :, None] + dmz, 0.0)


def extract_xic_4d(
    peak_mz: torch.Tensor,  # f32[N]
    peak_intensity: torch.Tensor,  # f32[N]
    peak_scanbin: torch.Tensor,  # i16[N]
    cell_start: torch.Tensor,  # i32 or i64[n_slots, n_bins, n_cycles+1]
    slot_idx: torch.Tensor,  # i32[B, Q]
    query_mz: torch.Tensor,  # f32[B, Q]
    tol_ppm: float,
    cycle_start: torch.Tensor,  # i32[B]
    *,
    n_cycles: int,
    n_bins: int,
    bin_mz_min: float,
    bin_width: float,
    n_scan_bins: int,
    slab: int = 256,
    window_len: int = 64,
    with_mz: bool = False,
):
    """Dense 4D XICs resolved per mobility scan bin: intensity
    f32[B, Q, S, W] and, with ``with_mz``, the per-cell m/z delta from the
    query centre. The slab values split into S scan-bin channels before the
    prefix sums, so each (scan, cycle) cell is two boundary lookups. A
    strided ``cell_start`` (``DiaData.cell_index(stride)``) gives the coarse
    view: its cells already merge ``stride`` cycles."""
    W, S = window_len, n_scan_bins
    dev = slot_idx.device
    cyc = (cycle_start.long()[:, None, None] + torch.arange(W + 1, device=dev)).clamp(0, n_cycles)
    rel, g_idx, g_mz, g_int, vmask, qc = _slab_reads(
        peak_mz, peak_intensity, cell_start, slot_idx, query_mz, tol_ppm, cyc,
        n_bins=n_bins, bin_mz_min=bin_mz_min, bin_width=bin_width, slab=slab,
    )
    onehot = peak_scanbin[g_idx][..., None] == torch.arange(S, device=dev)  # [B, Q, K, S]

    def scan_cells(v):  # [B, Q, K] -> [B, Q, S, W]
        return _cell_sums(torch.where(onehot, v[..., None], 0.0), rel).transpose(2, 3)

    intensity = scan_cells(torch.where(vmask, g_int, 0.0))
    if not with_mz:
        return intensity
    dmz_sum = scan_cells(torch.where(vmask, g_int * (g_mz - qc[:, :, None]), 0.0))
    return intensity, torch.where(intensity > 0, dmz_sum / intensity.clamp(min=1e-12), 0.0)


def extract_scan_profile(
    peak_mz: torch.Tensor,  # f32[N]
    peak_intensity: torch.Tensor,  # f32[N]
    peak_scanbin: torch.Tensor,  # i16[N]
    cell_start: torch.Tensor,  # i32 or i64[n_slots, n_bins, n_cycles+1]
    slot_idx: torch.Tensor,  # i32[B, Q]
    query_mz: torch.Tensor,  # f32[B, Q]
    tol_ppm: float,
    cycle_lo: torch.Tensor,  # i32[B] window start (inclusive)
    cycle_hi: torch.Tensor,  # i32[B] window stop (exclusive)
    *,
    n_cycles: int,
    n_bins: int,
    bin_mz_min: float,
    bin_width: float,
    n_scan_bins: int,
    slab: int = 256,
):
    """Mobility scan profiles f32[B, Q, S]: matched intensity summed over the
    cycle window [cycle_lo, cycle_hi), per scan bin. Only the window's two
    boundaries are looked up; the sum over the slab runs in float64."""
    dev = slot_idx.device
    cyc = torch.stack([cycle_lo.long(), cycle_hi.long()], dim=-1).clamp(0, n_cycles)[:, None, :]
    _, g_idx, _, g_int, vmask, _ = _slab_reads(
        peak_mz, peak_intensity, cell_start, slot_idx, query_mz, tol_ppm, cyc,
        n_bins=n_bins, bin_mz_min=bin_mz_min, bin_width=bin_width, slab=slab,
    )
    onehot = peak_scanbin[g_idx][..., None] == torch.arange(n_scan_bins, device=dev)
    v = torch.where(vmask, g_int, 0.0)[..., None]
    return torch.where(onehot, v, 0.0).sum(dim=2, dtype=torch.float64).float()


def extract_xic_packed(
    store,  # PeakStore (DiaData.device_arrays)
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
    """``extract_xic`` with the CUDA kernel's signature: the peak store,
    ``cycle_stride`` and the scan window over the store's scan bins. The
    plain version takes each cell's peaks from ``cell_start``; a coarse
    view's strided ``cell_start`` already merges ``cycle_stride`` cycles
    into one cell, so it needs neither the cycle plane nor the stride."""
    del cycle_stride
    scan_kw = {}
    if scan_lo is not None:
        scan_kw = dict(peak_scanbin=store.scanbin, scan_lo=scan_lo, scan_hi=scan_hi)
    return extract_xic(
        store.packed[:, 0], store.packed[:, 1], cell_start, slot_idx, query_mz,
        tol_ppm, cycle_start, **kw, **scan_kw,
    )
