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
