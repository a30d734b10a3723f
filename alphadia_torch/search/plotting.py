"""Kernel debug plots: what the selection and scoring kernels saw.

The JAX package's four plotters (the DIA cycle scheme, per-fragment XICs
with the quadrupole-weighted template, the isotope traces, the selection
score) drawn through the port's figure layer (``reporting/figure.py``),
with JAX's figure sizes, names and return values.

:func:`debug_candidates` extracts the dense XICs of chosen candidates again
through the XIC kernel's wrapper on the scoring driver's peak store: the
kernel on the card, its plain version on CPU tensors. Its window starts
``W // 2`` cycles before the candidate's centre, as JAX's does: the figure
is a picture of that window, not of the scoring read.
"""

from __future__ import annotations

import numpy as np
import torch

from alphadia_torch.ops.features import logistic_rectangle
from alphadia_torch.ops.xic_cuda import extract_xic_cuda
from alphadia_torch.reporting.figure import subplots
from alphadia_torch.reporting.reporting import FigureBackend
from alphadia_torch.utils.frame import take


def plot_dia_cycle(dia, ax=None):
    """Isolation windows: the m/z extent of each slot of the cycle; an MS1
    slot as a grey band."""
    if ax is None:
        _, ax = subplots(figsize=(7, 3))
    cyc = dia.cycle[0, :, 0, :]  # [n_slots, 2]
    for slot, (lo, hi) in enumerate(cyc):
        if lo < 0:
            ax.axhspan(slot - 0.4, slot + 0.4, color="#999", alpha=0.25)
            ax.text(0.01, slot, "MS1", va="center", transform=ax.get_yaxis_transform())
        else:
            ax.barh(slot, hi - lo, left=lo, height=0.8, color="#4878d0", alpha=0.7)
    ax.set_xlabel("isolation m/z")
    ax.set_ylabel("cycle slot")
    ax.set_title(f"DIA cycle: {dia.n_slots} slots x {dia.n_cycles} cycles")
    return ax.figure


def plot_fragment_profiles(
    dense_int: np.ndarray,  # [KF, O2, W]
    template: np.ndarray,  # [O2, W]
    frag_mz: np.ndarray,  # [KF]
    fmask: np.ndarray,  # [KF]
    title: str = "",
):
    """Per observation the XIC of each unmasked fragment, and the template
    scaled to the highest trace (dashed, where it is not zero)."""
    KF, O2, W = dense_int.shape
    fig, axes = subplots(1, O2, figsize=(4 * O2, 3.2), squeeze=False, sharey=True)
    x = np.arange(W)
    for o in range(O2):
        ax = axes[0, o]
        for f in range(KF):
            if not fmask[f]:
                continue
            ax.plot(x, dense_int[f, o], lw=1, alpha=0.8, label=f"{frag_mz[f]:.2f}")
        t = template[o]
        if t.max() > 0:
            scale = max(dense_int[:, o].max(), 1e-9) / max(t.max(), 1e-9)
            ax.plot(x, t * scale, "k--", lw=2, label="template")
        ax.set_xlabel("cycle (window)")
        ax.set_title(f"obs {o}")
        if KF <= 8:
            ax.legend(fontsize=6)
    axes[0, 0].set_ylabel("intensity")
    if title:
        fig.suptitle(title, fontsize=9)
    fig.tight_layout()
    return fig


def plot_precursor_profiles(
    dense_int: np.ndarray,  # [KI, W]
    iso_mz: np.ndarray,  # [KI]
    title: str = "",
):
    """The XIC of each isotope of the precursor."""
    KI, W = dense_int.shape
    fig, ax = subplots(figsize=(4.5, 3.2))
    x = np.arange(W)
    for k in range(KI):
        ax.plot(x, dense_int[k], lw=1.2, label=f"i{k} {iso_mz[k]:.3f}")
    ax.set_xlabel("cycle (window)")
    ax.set_ylabel("intensity")
    ax.legend(fontsize=7)
    if title:
        ax.set_title(title, fontsize=9)
    fig.tight_layout()
    return fig


def plot_selection_score(
    score_profile: np.ndarray,  # [W] smoothed log-score over the RT window
    peaks: np.ndarray,  # indices of chosen candidate apexes
    extents: list[tuple[int, int]] | None = None,
    title: str = "",
):
    """The smoothed selection score with the chosen apexes and extents."""
    fig, ax = subplots(figsize=(5, 2.8))
    x = np.arange(len(score_profile))
    ax.plot(x, score_profile, lw=1.2, color="#4878d0")
    for p in np.atleast_1d(peaks):
        ax.axvline(p, color="#d65f5f", lw=1)
    for a, b in extents or []:
        ax.axvspan(a, b, color="#d65f5f", alpha=0.12)
    ax.set_xlabel("cycle (window)")
    ax.set_ylabel("selection score")
    if title:
        ax.set_title(title, fontsize=9)
    fig.tight_layout()
    return fig


def debug_dense(scoring, cand: dict) -> dict:
    """The dense tensors of each candidate of ``cand``, extracted again on
    the scoring driver's device: ``fragments`` f32[n, KF, O2, W], ``isotopes``
    f32[n, KI, W] (summed over the MS1 observations), ``template`` f32[n, O2,
    W] and the candidate arrays they came from (``arrays``). Two launches of
    the XIC wrapper, one for the fragments and one for the isotopes of every
    candidate."""
    arrays = scoring._candidate_arrays(cand)
    dia = scoring.dia
    cfg = scoring.config
    W = arrays["window_len"]
    n = len(arrays["frame_center"])
    dev = dia.device_arrays(1, scoring.device)
    device = dev["cell_start"].device
    kw = dict(
        n_cycles=dev["n_cycles"], n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min,
        bin_width=dia.coarse_bin_width, slab=cfg.gather_slab, window_len=W,
    )
    cstart = torch.from_numpy((arrays["frame_center"] - W // 2).astype(np.int32)).to(device)

    def extract(slot, mz, tol):
        return extract_xic_cuda(
            dev["peak_store"], dev["cell_start"],
            torch.from_numpy(np.array(slot.reshape(n, -1), np.int32)).to(device),
            torch.from_numpy(np.array(mz.reshape(n, -1), np.float32)).to(device),
            tol, cstart, **kw,
        ).cpu().numpy()

    fslot = np.where(arrays["frag_valid"][:, :, None], arrays["ms2_slot"][:, None, :], -1)
    _, KF, O2 = fslot.shape
    fmz = np.broadcast_to(arrays["frag_mz"][:, :, None], fslot.shape)
    d_frag = extract(fslot, fmz, cfg.fragment_mz_tolerance).reshape(n, KF, O2, W)
    KI = arrays["iso_mz"].shape[1]
    O1 = arrays["ms1_slot"].shape[1]
    islot = np.broadcast_to(arrays["ms1_slot"][:, None, :], (n, KI, O1))
    imz = np.broadcast_to(arrays["iso_mz"][:, :, None], (n, KI, O1))
    d_prec = extract(islot, imz, cfg.precursor_mz_tolerance).reshape(n, KI, O1, W).sum(axis=2)
    qtf = logistic_rectangle(
        torch.from_numpy(arrays["win_lo"][:, None, :]), torch.from_numpy(arrays["win_hi"][:, None, :]),
        cfg.quad_sigma[0], cfg.quad_sigma[1], torch.from_numpy(arrays["iso_mz"][:, :, None]),
    ).numpy()  # [n, KI, O2]
    template = (arrays["iso_intensity"][:, :, None, None] * qtf[:, :, :, None] * d_prec[:, :, None, :]).sum(axis=1)
    return {"fragments": d_frag, "isotopes": d_prec, "template": template, "arrays": arrays}


def debug_candidates(scoring, candidates: dict, n: int = 3, figure_dir=None) -> list:
    """Extract the dense tensors of the first ``n`` candidates of a
    :class:`~alphadia_torch.search.scoring.CandidateScoring` driver again
    and draw each one's fragment (with the template) and isotope figures,
    written as ``debug_<precursor_idx>_{fragments,precursor}.png`` into
    ``figure_dir`` when it is given. Returns the figures' names."""
    backend = FigureBackend(figure_dir) if figure_dir is not None else None
    cand = take(candidates, slice(0, n))
    if not len(cand["precursor_idx"]):
        return []
    dense = debug_dense(scoring, cand)
    arrays = dense["arrays"]
    names = []
    for i, pid in enumerate(np.asarray(cand["precursor_idx"]).tolist()):
        pid = int(pid)
        f1 = plot_fragment_profiles(
            dense["fragments"][i], dense["template"][i], arrays["frag_mz"][i], arrays["frag_valid"][i],
            title=f"precursor {pid}",
        )
        f2 = plot_precursor_profiles(dense["isotopes"][i], arrays["iso_mz"][i], title=f"precursor {pid} isotopes")
        for tag, fig in (("fragments", f1), ("precursor", f2)):
            name = f"debug_{pid}_{tag}"
            if backend is not None:
                backend.log_figure(name, fig)
            names.append(name)
    return names
