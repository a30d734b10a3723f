"""Batched candidate peak-group selection, 3D and 4D.

One call processes a batch of B precursors:

    XIC (fragments + MS1 isotopes, CUDA kernel on the card)
    -> Gaussian smoothing along cycles
    -> score = sum log1p(fragment XICs) + sum log1p(isotope XICs),
       standardized per precursor
    -> 5-point-stencil peaks, top-k
    -> close-peak suppression
    -> symmetric extent growth
    -> overlapping-candidate merge

Outputs a candidate set [B, C] in absolute cycle coordinates.
``select_candidates_batch_4d`` keeps the scan axis of ion-mobility data:
its score map is [B, S, W] and it also returns scan_center, scan_start and
scan_stop in scan-bin coordinates. Its XICs are resolved per scan bin by
the scan-resolved kernel on the card (``ops/scan_cells_cuda``; on the CPU
its plain version ``ops/xic.extract_xic_4d``, as in the JAX package).
"""

from __future__ import annotations

import torch

from alphadia_torch.ops.peaks import (
    find_peaks_profile,
    find_peaks_profile_2d,
    join_overlapping_1d,
    join_overlapping_2d,
    suppress_close_peaks,
    suppress_close_peaks_2d,
    symmetric_limits_2d,
    symmetric_limits_profile,
)
from alphadia_torch.ops.scan_cells_cuda import extract_xic_4d_cuda
from alphadia_torch.ops.smooth import convolve_profiles
from alphadia_torch.ops.xic_cuda import extract_xic_cuda


def select_candidates_batch(
    peak_store,  # PeakStore (DiaData.device_arrays)
    cell_start,  # i32 or i64[n_slots, n_bins, n_cycles+1]
    frag_slot,  # i32[B, QF] cycle slot per fragment query (-1 pad)
    frag_mz,  # f32[B, QF]
    iso_slot,  # i32[B, QI]
    iso_mz,  # f32[B, QI]
    cycle_start,  # i32[B] first cycle of each precursor's window
    kernel,  # f32[kernel_size]
    fragment_tol_ppm: float,
    precursor_tol_ppm: float,
    n_valid_fragments,  # i32[B] (selection requires > 3)
    *,
    n_cycles: int,
    n_bins: int,
    bin_mz_min: float,
    bin_width: float,
    slab: int,
    window_len: int,
    kernel_size: int,
    candidate_count: int,
    min_size_rt: int = 3,
    max_size_rt: int = 15,
    f_rt: float = 0.99,
    center_fraction: float = 0.5,
    join_close_candidates: bool = True,
    join_cycle_threshold: float = 0.6,
    peak_cycle_tolerance: int = 3,
    cycle_stride: int = 1,
):
    xic_kw = dict(
        n_cycles=n_cycles, n_bins=n_bins, bin_mz_min=bin_mz_min,
        bin_width=bin_width, slab=slab, window_len=window_len,
        cycle_stride=cycle_stride,
    )
    dense_frag = extract_xic_cuda(
        peak_store, cell_start, frag_slot, frag_mz, fragment_tol_ppm,
        cycle_start, **xic_kw,
    )  # [B, QF, W]
    dense_iso = extract_xic_cuda(
        peak_store, cell_start, iso_slot, iso_mz, precursor_tol_ppm,
        cycle_start, **xic_kw,
    )  # [B, QI, W]

    smooth_frag = convolve_profiles(dense_frag, kernel, kernel_size=kernel_size)
    smooth_iso = convolve_profiles(dense_iso, kernel, kernel_size=kernel_size)
    feature = torch.log1p(smooth_frag.clamp(min=0.0)).sum(dim=1) + torch.log1p(
        smooth_iso.clamp(min=0.0)
    ).sum(dim=1)  # [B, W]

    mean = feature.mean(dim=1, keepdim=True)
    std = feature.std(dim=1, keepdim=True, correction=0)
    score = (feature - mean) / (std + 1e-6)

    peak_idx, peak_score, valid = find_peaks_profile(score, top_n=candidate_count)
    keep = suppress_close_peaks(peak_idx, valid, peak_cycle_tolerance)
    start_rel, stop_rel = symmetric_limits_profile(
        score,
        peak_idx.clamp(min=0),
        f=f_rt,
        center_fraction=center_fraction,
        min_size=min_size_rt,
        max_size=max_size_rt,
    )
    if join_close_candidates:
        start_rel, stop_rel, keep = join_overlapping_1d(
            start_rel, stop_rel, keep, join_cycle_threshold
        )
    keep = keep & (n_valid_fragments > 3)[:, None]

    cyc0 = cycle_start[:, None]
    rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    return {
        "valid": keep,
        "rank": torch.where(keep, rank, 0).to(torch.int32),
        "score": torch.where(keep, peak_score, 0.0).to(torch.float32),
        "cycle_center": (cyc0 + peak_idx).clamp(0, n_cycles - 1).to(torch.int32),
        "cycle_start": (cyc0 + start_rel).clamp(0, n_cycles).to(torch.int32),
        "cycle_stop": (cyc0 + stop_rel).clamp(0, n_cycles).to(torch.int32),
    }


_SCAN_SMOOTH = (0.25, 0.5, 0.25)  # fixed 3-tap kernel along the scan axis


def select_candidates_batch_4d(
    peak_store,  # PeakStore (DiaData.device_arrays)
    cell_start,  # i32 or i64[n_slots, n_bins, n_cycles+1], fine or strided
    frag_slot,  # i32[B, QF]
    frag_mz,  # f32[B, QF]
    iso_slot,  # i32[B, QI]
    iso_mz,  # f32[B, QI]
    cycle_start,  # i32[B]
    kernel,  # f32[kernel_size]
    fragment_tol_ppm: float,
    precursor_tol_ppm: float,
    n_valid_fragments,  # i32[B]
    *,
    n_cycles: int,
    n_bins: int,
    bin_mz_min: float,
    bin_width: float,
    n_scan_bins: int,
    slab: int,
    window_len: int,
    kernel_size: int,
    candidate_count: int,
    min_size_rt: int = 3,
    max_size_rt: int = 15,
    min_size_mobility: int = 2,
    max_size_mobility: int = 6,
    f_rt: float = 0.99,
    f_mobility: float = 0.99,
    center_fraction: float = 0.5,
    peak_cycle_tolerance: int = 3,
    peak_scan_tolerance: int = 3,
    join_close_candidates: bool = True,
    join_cycle_threshold: float = 0.6,
):
    W, S = window_len, n_scan_bins
    xic_kw = dict(
        n_cycles=n_cycles, n_bins=n_bins, bin_mz_min=bin_mz_min,
        bin_width=bin_width, n_scan_bins=S, slab=slab, window_len=W,
    )
    dense_frag = extract_xic_4d_cuda(
        peak_store, cell_start, frag_slot, frag_mz, fragment_tol_ppm, cycle_start, **xic_kw,
    )  # [B, QF, S, W]
    dense_iso = extract_xic_4d_cuda(
        peak_store, cell_start, iso_slot, iso_mz, precursor_tol_ppm, cycle_start, **xic_kw,
    )  # [B, QI, S, W]

    def smooth(x):
        b, q = x.shape[:2]
        y = convolve_profiles(x.reshape(b * q * S, W), kernel, kernel_size=kernel_size).reshape(b, q, S, W)
        # light smoothing along the scan axis, edges replicated
        up = torch.cat([y[:, :, :1], y[:, :, :-1]], dim=2)
        dn = torch.cat([y[:, :, 1:], y[:, :, -1:]], dim=2)
        return _SCAN_SMOOTH[1] * y + _SCAN_SMOOTH[0] * up + _SCAN_SMOOTH[2] * dn

    feature = torch.log1p(smooth(dense_frag).clamp(min=0.0)).sum(dim=1) + torch.log1p(
        smooth(dense_iso).clamp(min=0.0)
    ).sum(dim=1)  # [B, S, W]
    mean = feature.mean(dim=(1, 2), keepdim=True)
    std = feature.std(dim=(1, 2), keepdim=True, correction=0)
    score = (feature - mean) / (std + 1e-6)

    scan_idx, cycle_idx, peak_score, valid = find_peaks_profile_2d(score, top_n=candidate_count)
    # a peak goes only when it is close to a better one in scan AND cycle
    keep = suppress_close_peaks_2d(scan_idx, cycle_idx, valid, peak_scan_tolerance, peak_cycle_tolerance)
    scan_start, scan_stop, start_rel, stop_rel = symmetric_limits_2d(
        score,
        scan_idx.clamp(min=0),
        cycle_idx.clamp(min=0),
        f_mobility=f_mobility,
        f_rt=f_rt,
        center_fraction=center_fraction,
        min_size_mobility=min_size_mobility,
        max_size_mobility=max_size_mobility,
        min_size_rt=min_size_rt,
        max_size_rt=max_size_rt,
    )
    if join_close_candidates:
        scan_start, scan_stop, start_rel, stop_rel, keep = join_overlapping_2d(
            scan_start, scan_stop, start_rel, stop_rel, keep,
            p_scan_overlap=0.01, p_cycle_overlap=join_cycle_threshold,
        )
    keep = keep & (n_valid_fragments > 3)[:, None]

    cyc0 = cycle_start[:, None]
    rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
    return {
        "valid": keep,
        "rank": torch.where(keep, rank, 0).to(torch.int32),
        "score": torch.where(keep, peak_score, 0.0).to(torch.float32),
        "cycle_center": (cyc0 + cycle_idx).clamp(0, n_cycles - 1).to(torch.int32),
        "cycle_start": (cyc0 + start_rel).clamp(0, n_cycles).to(torch.int32),
        "cycle_stop": (cyc0 + stop_rel).clamp(0, n_cycles).to(torch.int32),
        "scan_center": scan_idx.clamp(0, S - 1).to(torch.int32),
        "scan_start": scan_start.clamp(0, S).to(torch.int32),
        "scan_stop": scan_stop.clamp(0, S).to(torch.int32),
    }
