"""RT-windowed search: device memory bounded by a window, not by the run.

The run is searched in RT windows: the peak store is built for one
window's cycles (padded by the selection window, so that every XIC is
complete), the library slice whose RT falls in the window's core is
searched, the store leaves the device, and the next window follows. Core
ranges partition the RT axis, so each precursor is searched once, and the
pad gives every candidate its full selection window and scoring extent, so
the scores equal a whole-run search's. The pad is the selection window as
candidate selection buckets it (the JAX version pads by the RT tolerance
alone, which the bucketed window can exceed), plus 30 s. On ion-mobility data every
window keeps the whole run's scan bins (the JAX driver bins each window by
its own mobility range, which moves the 4D candidates).
"""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.rawdata.diadata import DiaData
from alphadia_torch.rawdata.source import SpectrumData
from alphadia_torch.search.pipelined import PipelinedExtraction
from alphadia_torch.search.scoring import ScoringConfig, empty_fragments, empty_psms
from alphadia_torch.search.selection import SelectionConfig
from alphadia_torch.utils.device import bucket_window, resolve_device
from alphadia_torch.utils.frame import concat, take

logger = logging.getLogger(__name__)


def iter_rt_windows(spectra: SpectrumData, n_windows: int, pad_s: float):
    """Yield ``((core_lo, core_hi), sub_spectra, cycle_offset)`` for
    ``n_windows`` equal RT windows, each padded by ``pad_s`` seconds and cut
    on MS1 spectra, so that ``DiaData`` sees whole cycles."""
    ms1_idx = np.nonzero(spectra.ms_level == 1)[0]
    if len(ms1_idx) < 2:  # no cycle structure: one window
        yield (float("-inf"), float("inf")), spectra, 0
        return
    cyc_rt = spectra.rt[ms1_idx]
    edges = np.linspace(float(cyc_rt[0]), float(spectra.rt[-1]), n_windows + 1)
    n_cyc = len(ms1_idx)
    for w in range(n_windows):
        core_lo = float(edges[w]) if w else float("-inf")
        core_hi = float(edges[w + 1]) if w < n_windows - 1 else float("inf")
        c0 = int(np.searchsorted(cyc_rt, edges[w] - pad_s, side="left"))
        c1 = int(np.searchsorted(cyc_rt, edges[w + 1] + pad_s, side="right"))
        c0, c1 = max(c0, 0), min(max(c1, c0 + 1), n_cyc)
        s0 = int(ms1_idx[c0])
        s1 = int(ms1_idx[c1]) if c1 < n_cyc else spectra.n_spectra
        yield (core_lo, core_hi), spectra.select(np.arange(s0, s1)), c0


def selection_half_window_s(spectra: SpectrumData | None, cfg: SelectionConfig) -> float:
    """Seconds that candidate selection searches on either side of a
    precursor's library RT: ``rt_tolerance``, or half the selection window
    where the bucket rounds it up (120 s at a 1.5 s cycle is 80 cycles, a
    window of 128: 96 s a side). The JAX driver pads by ``rt_tolerance``
    alone, so the selection windows of precursors near a window's edge were
    clipped there and their candidates moved."""
    ms1_rt = spectra.rt[spectra.ms_level == 1] if spectra is not None else np.zeros(0)
    cycle_time = float(np.median(np.diff(ms1_rt))) if len(ms1_rt) > 1 else 0.0
    if cycle_time <= 0.0:
        return cfg.rt_tolerance
    need = int(np.ceil(2.0 * cfg.rt_tolerance / cycle_time))
    window = bucket_window(max(need, 32, cfg.kernel_size))
    return max(cfg.rt_tolerance, (window // 2 + 1) * cycle_time)


def device_megabytes(dev: dict) -> float:
    """MB that one ``DiaData.device_arrays`` view holds on the device: the
    peak store's planes, ``cell_start`` and ``cycle_rt`` (``peak_mz``,
    ``peak_intensity`` and ``peak_scanbin`` are views of the store)."""
    tensors = [*dev["peak_store"], dev["cell_start"], dev["cycle_rt"]]
    return sum(t.numel() * t.element_size() for t in tensors) / 1e6


class RtWindowedSearch:
    """Selection and scoring over RT windows of one run. Returns the
    (psm, fragment) column dicts of a whole-run ``PipelinedExtraction``,
    with the candidates' ``frame_*`` columns in absolute cycles."""

    def __init__(
        self,
        spectra: SpectrumData,
        precursor: dict,
        fragment: dict,
        sel_config: SelectionConfig | None = None,
        score_config: ScoringConfig | None = None,
        rt_column: str = "rt_library",
        precursor_mz_column: str = "mz_library",
        fragment_mz_column: str = "mz_library",
        n_rt_windows: int = 8,
        pad_s: float | None = None,
        diadata_kwargs: dict | None = None,
        device=None,
    ):
        self.spectra = spectra
        self.precursor = precursor
        self.fragment = fragment
        self.sel_config = sel_config or SelectionConfig()
        self.score_config = score_config or ScoringConfig()
        self.cols = dict(
            rt_column=rt_column,
            precursor_mz_column=precursor_mz_column,
            fragment_mz_column=fragment_mz_column,
        )
        self.n_rt_windows = n_rt_windows
        # the pad covers the selection window and 30 s of scoring extent
        self.pad_s = pad_s if pad_s is not None else selection_half_window_s(spectra, self.sel_config) + 30.0
        self.diadata_kwargs = dict(diadata_kwargs or {})
        if spectra is not None and spectra.has_mobility:
            # every window bins mobility as the whole run does: a window's
            # own range would move the scan bins, and with them the 4D
            # candidates and features
            self.diadata_kwargs.setdefault(
                "mobility_range", (float(spectra.mobility.min()), float(spectra.mobility.max()))
            )
        self.device = resolve_device(device)

    def __call__(self) -> tuple[dict, dict]:
        prec = self.precursor
        rt = prec[self.cols["rt_column"]].astype(np.float32)
        psms, frags = [], []
        peak_slab_mb = 0.0
        for (lo, hi), sub, c0 in iter_rt_windows(self.spectra, self.n_rt_windows, self.pad_s):
            rows = np.nonzero((rt >= lo) & (rt < hi))[0]
            if not len(rows):
                continue
            dia = DiaData.from_spectra(sub, **self.diadata_kwargs)
            slab_mb = device_megabytes(dia.device_arrays(1, self.device))
            peak_slab_mb = max(peak_slab_mb, slab_mb)
            _, psm, fr = PipelinedExtraction(
                dia, take(prec, rows), self.fragment, self.sel_config, self.score_config,
                device=self.device, **self.cols,
            )()
            # window-local cycles -> absolute
            for col in ("frame_start", "frame_center", "frame_stop"):
                if col in psm:
                    psm[col] = psm[col] + c0
            psms.append(psm)
            frags.append(fr)
            dia.free_device()
            logger.info(
                "RT window [%.0f, %.0f) s: %d precursors -> %d PSMs (store %.0f MB)",
                lo, hi, len(rows), len(psm["precursor_idx"]), slab_mb,
            )
        self.peak_window_slab_mb = peak_slab_mb
        if not psms:
            return empty_psms(), empty_fragments()
        return concat(psms), concat(frags)
