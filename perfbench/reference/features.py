# Frozen copy of alphadia_torch/ops/features.py, lines 1-167, at commit b5dd55e, imports
# rewritten to this package; the plain reference of the benchmark. Edits below
# the copy are marked "reference:".
"""Batched, masked feature primitives of candidate scoring.

Profiles are [..., W] along the cycle axis with the candidate apex
re-centred at W // 2; ``mask`` marks real (non-padding) entries. Each
helper computes what its namesake in the JAX package computes, in the same
dtype: the bfloat16 scoring path runs these on bfloat16 tensors.
"""

from __future__ import annotations

import torch

from perfbench.reference.peaks import top_k_stable


def logistic_rectangle(mu1, mu2, sigma1, sigma2, x):
    """Quadrupole transmission: rising logistic at mu1 minus one at mu2."""
    return torch.sigmoid((x - mu1) / sigma1) - torch.sigmoid((x - mu2) / sigma2)


def masked_corrcoef(x, y, mask, dim=-1, eps=1e-12):
    """Pearson correlation over masked entries along ``dim``."""
    m = mask.to(x.dtype)
    n = m.sum(dim=dim, keepdim=True).clamp(min=1.0)
    xm = (x * m).sum(dim=dim, keepdim=True) / n
    ym = (y * m).sum(dim=dim, keepdim=True) / n
    xc = (x - xm) * m
    yc = (y - ym) * m
    num = (xc * yc).sum(dim=dim)
    den = torch.sqrt((xc**2).sum(dim=dim) * (yc**2).sum(dim=dim))
    return num / (den + eps)


def cosine_rows(x, template, eps=1e-4):
    """Cosine similarity of [..., W] rows against a broadcastable template."""
    x_norm = torch.sqrt((x**2).sum(dim=-1))
    t_norm = torch.sqrt((template**2).sum(dim=-1))
    return (x * template).sum(dim=-1) / (x_norm * t_norm + eps)


def pearson_rows_masked(x, y, mask, eps=1e-12):
    """Row-wise Pearson over the masked positions; entries outside the mask
    must already be zero (moments use the masked count)."""
    m = mask.to(x.dtype)
    cnt = m.sum(dim=-1, keepdim=True).clamp(min=1.0)
    xm = x.sum(dim=-1, keepdim=True) / cnt
    ym = y.sum(dim=-1, keepdim=True) / cnt
    xc = (x - xm) * m
    yc = (y - ym) * m
    num = (xc * yc).sum(dim=-1)
    den = torch.sqrt((xc**2).sum(dim=-1) * (yc**2).sum(dim=-1))
    return num / (den + eps)


def or_envelope(x):
    """Replace local dips of [..., L] profiles by the mean of their two
    neighbours (the edges stay)."""
    left, mid, right = x[..., :-2], x[..., 1:-1], x[..., 2:]
    dip = (mid < left) | (mid < right)
    repaired = torch.where(dip, (left + right) * 0.5, mid)
    return torch.cat([x[..., :1], repaired, x[..., -1:]], dim=-1)


def center_envelope_odd(x, center: int):
    """Interference-correction envelope walking outwards from ``center``
    (static index). Returns a corrected copy of x [..., W]."""
    W = x.shape[-1]
    out = x.clone()
    left_int = (x[..., center - 1] + x[..., center]) * 0.5
    right_int = (x[..., center + 1] + x[..., center]) * 0.5
    for i in range(1, center + 1):
        li, ri = center - i, center + i
        if li < 0 or ri >= W:
            break
        new_l = torch.minimum(left_int, out[..., li])
        out[..., li] = new_l
        left_int = (new_l + out[..., li + 1]) * 0.5
        new_r = torch.minimum(right_int, out[..., ri])
        out[..., ri] = new_r
        right_int = (new_r + out[..., ri - 1]) * 0.5
    return out


def weighted_center_of_mass(profile, mask):
    """Intensity-weighted frame mean over [..., W]: returns (com, total)."""
    W = profile.shape[-1]
    frames = torch.arange(W, dtype=profile.dtype, device=profile.device)
    w = torch.where(mask, profile, 0.0)
    total = w.sum(dim=-1)
    com = torch.where(
        total > 0, (w * frames).sum(dim=-1) / total.clamp(min=1e-12), 0.0
    )
    return com, total


def weighted_center_mean(values, center, mask, scan_dist_sq=(0.25, 0.25), nonzero=None):
    """exp(-0.1 * distance)-weighted mean of nonzero values.

    Each nonzero frame contributes two terms at distances sqrt(s0 + df^2)
    and sqrt(s1 + df^2) (the reference's two-row dummy scan axis);
    ``nonzero`` overrides the presence test ``values > 0``."""
    W = values.shape[-1]
    frames = torch.arange(W, dtype=values.dtype, device=values.device)
    nz = ((values > 0) if nonzero is None else nonzero) & mask
    dsq = torch.square(frames - center[..., None])
    w = torch.exp(-0.1 * torch.sqrt(scan_dist_sq[0] + dsq)) + torch.exp(
        -0.1 * torch.sqrt(scan_dist_sq[1] + dsq)
    )
    w = torch.where(nz, w, 0.0)
    wsum = w.sum(dim=-1)
    return torch.where(
        wsum > 0, (values * w).sum(dim=-1) / wsum.clamp(min=1e-12), 0.0
    )


def masked_median(x, mask, dim=0):
    """Median over masked entries, the mean of the two middle values for an
    even count (as ``jnp.nanmedian``; ``torch.nanmedian`` returns the lower
    one), 0 where nothing is masked in."""
    n = mask.sum(dim=dim, keepdim=True)
    s = torch.sort(torch.where(mask, x, float("inf")), dim=dim).values
    lo = torch.gather(s, dim, ((n - 1) // 2).clamp(min=0))
    hi = torch.gather(s, dim, (n // 2).clamp(max=x.shape[dim] - 1))
    med = ((lo + hi) * 0.5).squeeze(dim)
    return torch.where(n.squeeze(dim) > 0, med, 0.0)


def masked_mean(x, mask, dim=-1):
    m = mask.to(x.dtype)
    return (x * m).sum(dim=dim) / m.sum(dim=dim).clamp(min=1.0)


def ref_top3_ion_correlation(values, frag_mz, frag_int, mask, is_type):
    """The reference's top3_{b,y}_ion_correlation pick:

        fragment_idx_sorted = np.argsort(intensity)[::-1]
        sel = fragment_idx_sorted[type_mask][:3]   # mask in m/z order
        feature = correlation_list[sel].mean()

    Ties resolve like numpy's stable ascending sort reversed, matched with a
    stable argsort and a flip. Invalid slots sort to the tail of both."""
    inf = float("inf")
    perm = torch.argsort(torch.where(mask, frag_mz, inf), dim=1, stable=True)

    def g(a):
        return torch.gather(a, 1, perm)

    vals_m, int_m, valid_m, type_m = g(values), g(frag_int), g(mask), g(is_type)
    idx_sorted = torch.flip(
        torch.argsort(torch.where(valid_m, int_m, -inf), dim=1, stable=True), dims=(1,)
    )
    corr_at = torch.gather(vals_m, 1, idx_sorted)
    hit = type_m & valid_m
    rank = torch.cumsum(hit.to(torch.int32), dim=1) - 1
    limit = hit.sum(dim=1).clamp(max=3)
    total = torch.zeros(values.shape[0], dtype=values.dtype, device=values.device)
    for r in range(3):
        sel = hit & (rank == r)
        total = total + torch.where(r < limit, (sel * corr_at).sum(dim=1), 0.0)
    return torch.where(limit > 0, total / limit.clamp(min=1), 0.0)


def topk_mean_by(values, keys, mask, k=3):
    """Mean of ``values`` at the k largest ``keys`` among masked entries
    (the lower index first on ties)."""
    _, idx = top_k_stable(torch.where(mask, keys, float("-inf")), k)
    return masked_mean(torch.gather(values, -1, idx), torch.gather(mask, -1, idx))
