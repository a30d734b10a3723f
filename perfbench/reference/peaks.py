# Frozen copy of alphadia_torch/ops/peaks.py, lines 1-277, at commit b5dd55e, imports
# rewritten to this package; the plain reference of the benchmark. Edits below
# the copy are marked "reference:".
"""Peak finding and extent estimation on [B, W] score profiles.

- ``find_peaks_profile``: a peak at p needs the strict 5-point stencil
  a[p-2] < a[p-1] < a[p] > a[p+1] > a[p+2]; the top-n peaks by height are
  returned, the lower index first on ties (a stable descending sort, as
  ``jax.lax.top_k`` orders them; ``torch.topk`` promises no order);
- ``suppress_close_peaks``: among peaks within ``cycle_tolerance`` only the
  highest survives;
- ``symmetric_limits_profile``: extents grow symmetrically from the apex
  while the flank mean keeps dropping below ``f`` x the trailing value and
  stays above ``centre * center_fraction``, clamped to [min_size, max_size];
- ``join_overlapping_1d``: a lower-ranked candidate whose interval overlaps
  a kept one by more than ``p_overlap`` of that one's length merges into it.

The ``_2d`` functions do the same on [B, S, W] (scan x cycle) score maps of
ion-mobility data.
"""

from __future__ import annotations

import torch


def top_k_stable(x: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest entries along the last axis,
    the lower index first among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def find_peaks_profile(score: torch.Tensor, *, top_n: int):
    """[B, W] -> (peak_idx i32[B, top_n], peak_score f32[B, top_n], valid).

    Peaks come in descending score order; invalid slots have idx -1."""
    B, W = score.shape
    s = score
    stencil = torch.zeros((B, W), dtype=torch.bool, device=s.device)
    if W >= 5:
        stencil[:, 2:-2] = (
            (s[:, 2:-2] > s[:, 1:-3])
            & (s[:, 1:-3] > s[:, :-4])
            & (s[:, 2:-2] > s[:, 3:-1])
            & (s[:, 3:-1] > s[:, 4:])
        )
    masked = torch.where(stencil, s, float("-inf"))
    peak_score, peak_idx = top_k_stable(masked, top_n)
    valid = torch.isfinite(peak_score)
    peak_idx = torch.where(valid, peak_idx, -1)
    return peak_idx.to(torch.int32), peak_score, valid


def suppress_close_peaks(peak_idx, valid, cycle_tolerance: int):
    """Keep only the best peak within +-cycle_tolerance (columns must be
    score-descending: earlier columns win)."""
    keep = valid.clone()
    for i in range(1, peak_idx.shape[1]):
        close_to_better = torch.zeros_like(keep[:, 0])
        for j in range(i):
            close_to_better |= keep[:, j] & (
                (peak_idx[:, i] - peak_idx[:, j]).abs() <= cycle_tolerance
            )
        keep[:, i] &= ~close_to_better
    return keep


def symmetric_limits_profile(
    score: torch.Tensor,  # [B, W]
    center: torch.Tensor,  # [B, C]
    *,
    f: float,
    center_fraction: float,
    min_size: int,
    max_size: int,
):
    """Returns (start i32[B, C] inclusive, stop i32[B, C] exclusive)."""
    B, W = score.shape
    c = center.long().clamp(0, W - 1)
    center_int = torch.gather(score, 1, c)

    def flank(s):
        lo = (c - s).clamp(0, W - 1)
        hi = (c + s).clamp(0, W - 1)
        return (torch.gather(score, 1, lo) + torch.gather(score, 1, hi)) * 0.5

    limit = torch.full_like(c, min_size)
    trailing = center_int
    done = torch.zeros_like(c, dtype=torch.bool)
    for s in range(min_size + 1, max_size):
        inten = flank(s)
        dropping = inten < f * trailing
        above_floor = inten > center_int * center_fraction
        advance = ~done & dropping & above_floor
        limit = torch.where(advance, s, limit)
        trailing = torch.where(advance, inten, trailing)
        done = done | ~(dropping & above_floor)
    start = (c - limit).clamp(0, W)
    stop = (c + limit + 1).clamp(0, W)
    return start.to(torch.int32), stop.to(torch.int32)


def join_overlapping_1d(start, stop, keep, p_overlap: float):
    """Merge lower-ranked overlapping candidates into higher-ranked ones
    (overlap measured against the higher-ranked candidate's length)."""
    start, stop, keep = start.clone(), stop.clone(), keep.clone()
    C = start.shape[1]
    for i in range(C):
        for j in range(i + 1, C):
            length_i = (stop[:, i] - start[:, i]).float()
            ov = (
                torch.minimum(stop[:, i], stop[:, j])
                - torch.maximum(start[:, i], start[:, j])
            ).float() / length_i.clamp(min=1.0)
            do_join = keep[:, i] & keep[:, j] & (ov > p_overlap) & (ov >= 0)
            start[:, i] = torch.where(
                do_join, torch.minimum(start[:, i], start[:, j]), start[:, i]
            )
            stop[:, i] = torch.where(
                do_join, torch.maximum(stop[:, i], stop[:, j]), stop[:, i]
            )
            keep[:, j] &= ~do_join
    return start, stop, keep


def find_peaks_profile_2d(score: torch.Tensor, *, top_n: int):
    """[B, S, W] -> (scan_idx, cycle_idx, peak_score, valid), each [B, top_n],
    descending score. A peak needs the strict 5-point stencil along both
    axes. The scan axis is padded with a falling ramp (-1e-3, -2e-3 of the
    edge row, in float32) so apexes in the outermost of few scan bins can
    still pass."""
    B, S, W = score.shape
    first, last = score[:, :1], score[:, -1:]
    p = torch.cat([first - 2e-3, first - 1e-3, score, last - 1e-3, last - 2e-3], dim=1)
    stencil = torch.zeros((B, S, W), dtype=torch.bool, device=score.device)
    if W >= 5:
        c = p[:, 2:-2, 2:-2]
        along_scan = (
            (c > p[:, 1:-3, 2:-2])
            & (p[:, 1:-3, 2:-2] > p[:, :-4, 2:-2])
            & (c > p[:, 3:-1, 2:-2])
            & (p[:, 3:-1, 2:-2] > p[:, 4:, 2:-2])
        )
        along_cycle = (
            (c > p[:, 2:-2, 1:-3])
            & (p[:, 2:-2, 1:-3] > p[:, 2:-2, :-4])
            & (c > p[:, 2:-2, 3:-1])
            & (p[:, 2:-2, 3:-1] > p[:, 2:-2, 4:])
        )
        stencil[:, :, 2:-2] = along_scan & along_cycle
    masked = torch.where(stencil, score, float("-inf")).reshape(B, S * W)
    peak_score, flat_idx = top_k_stable(masked, top_n)
    valid = torch.isfinite(peak_score)
    scan_idx = torch.where(valid, flat_idx // W, -1).to(torch.int32)
    cycle_idx = torch.where(valid, flat_idx % W, -1).to(torch.int32)
    return scan_idx, cycle_idx, peak_score, valid


def _window_sums(score, center, half, along_scan: bool):
    """Score summed over the window [center - half, center + half) of one
    axis, as a profile along the other: [B, C, W] for ``along_scan`` (scan
    window), else [B, C, S] (cycle window). The terms are added one by one
    in index order, the same on every device."""
    B, S, W = score.shape
    L = S if along_scan else W
    out = None
    for d in range(-half, half):
        at = center.long() + d  # [B, C]
        inside = ((at >= 0) & (at < L))[:, :, None]
        if along_scan:
            x = torch.gather(score, 1, at.clamp(0, L - 1)[:, :, None].expand(B, -1, W))
        else:
            x = torch.gather(score, 2, at.clamp(0, L - 1)[:, None, :].expand(B, S, -1)).transpose(1, 2)
        x = torch.where(inside, x, 0.0)
        out = x if out is None else out + x
    return out


def symmetric_limits_2d(
    score: torch.Tensor,  # [B, S, W]
    scan_center: torch.Tensor,  # [B, C]
    cycle_center: torch.Tensor,  # [B, C]
    *,
    f_mobility: float,
    f_rt: float,
    center_fraction: float,
    min_size_mobility: int,
    max_size_mobility: int,
    min_size_rt: int,
    max_size_rt: int,
):
    """2D extents: scan limits from the profile summed over +-min_size_rt
    cycles around the apex, cycle limits from the profile summed over
    +-min_size_mobility scans. Returns (scan_start, scan_stop, cycle_start,
    cycle_stop), each i32[B, C]."""
    scan_profiles = _window_sums(score, cycle_center, min_size_rt, along_scan=False)
    cycle_profiles = _window_sums(score, scan_center, min_size_mobility, along_scan=True)
    scan_start, scan_stop = _limits_on_profiles(
        scan_profiles, scan_center, f_mobility, center_fraction, min_size_mobility, max_size_mobility
    )
    cyc_start, cyc_stop = _limits_on_profiles(
        cycle_profiles, cycle_center, f_rt, center_fraction, min_size_rt, max_size_rt
    )
    return scan_start, scan_stop, cyc_start, cyc_stop


def _limits_on_profiles(profiles, center, f, center_fraction, min_size, max_size):
    """``symmetric_limits_profile`` on per-candidate profiles [B, C, L] with
    centres [B, C]."""
    L = profiles.shape[2]
    c = center.long().clamp(0, L - 1)

    def at(i):
        return torch.gather(profiles, 2, i[:, :, None])[:, :, 0]

    center_int = at(c)
    limit = torch.full_like(c, min_size)
    trailing = center_int
    done = torch.zeros_like(c, dtype=torch.bool)
    for s in range(min_size + 1, max_size):
        inten = (at((c - s).clamp(0, L - 1)) + at((c + s).clamp(0, L - 1))) * 0.5
        dropping = inten < f * trailing
        above = inten > center_int * center_fraction
        advance = ~done & dropping & above
        limit = torch.where(advance, s, limit)
        trailing = torch.where(advance, inten, trailing)
        done = done | ~(dropping & above)
    start = (c - limit).clamp(0, L)
    stop = (c + limit + 1).clamp(0, L)
    return start.to(torch.int32), stop.to(torch.int32)


def suppress_close_peaks_2d(scan_idx, cycle_idx, valid, scan_tolerance: int, cycle_tolerance: int):
    """Keep only the best peak within a (scan, cycle) neighbourhood: a peak
    goes only when it is close to a better one in both axes, so features
    separated in mobility but co-eluting in RT stay apart (columns must be
    score-descending)."""
    keep = valid.clone()
    for i in range(1, cycle_idx.shape[1]):
        close_to_better = torch.zeros_like(keep[:, 0])
        for j in range(i):
            close_to_better |= (
                keep[:, j]
                & ((scan_idx[:, i] - scan_idx[:, j]).abs() <= scan_tolerance)
                & ((cycle_idx[:, i] - cycle_idx[:, j]).abs() <= cycle_tolerance)
            )
        keep[:, i] &= ~close_to_better
    return keep


def join_overlapping_2d(
    scan_start, scan_stop, cyc_start, cyc_stop, keep, p_scan_overlap: float, p_cycle_overlap: float
):
    """Merge a lower-ranked candidate whose (scan, cycle) extent overlaps a
    kept higher-ranked one into it (overlap fractions against the
    higher-ranked candidate, union limits on a join)."""
    scan_start, scan_stop = scan_start.clone(), scan_stop.clone()
    cyc_start, cyc_stop, keep = cyc_start.clone(), cyc_stop.clone(), keep.clone()

    def overlap(start, stop, i, j):
        length = (stop[:, i] - start[:, i]).float()
        ov = torch.minimum(stop[:, i], stop[:, j]) - torch.maximum(start[:, i], start[:, j])
        return ov.float() / length.clamp(min=1.0)

    C = scan_start.shape[1]
    for i in range(C):
        for j in range(i + 1, C):
            cyc_ov = overlap(cyc_start, cyc_stop, i, j)
            scan_ov = overlap(scan_start, scan_stop, i, j)
            do_join = (
                keep[:, i] & keep[:, j]
                & (scan_ov >= 0) & (cyc_ov >= 0)
                & (scan_ov > p_scan_overlap) & (cyc_ov > p_cycle_overlap)
            )
            for a, pick in ((scan_start, torch.minimum), (scan_stop, torch.maximum),
                            (cyc_start, torch.minimum), (cyc_stop, torch.maximum)):
                a[:, i] = torch.where(do_join, pick(a[:, i], a[:, j]), a[:, i])
            keep[:, j] &= ~do_join
    return scan_start, scan_stop, cyc_start, cyc_stop, keep
