"""Host driver of candidate selection.

Prepares the per-precursor query arrays on the host (numpy), uploads them
once, runs ``ops/selection.select_candidates_batch`` (or, on ion-mobility
data, ``select_candidates_batch_4d``) over a power-of-two batch schedule on
the device, and decodes the candidates into a column dict in absolute
(fine) cycle coordinates and, on 4D data, scan-bin coordinates.

``_submit`` enqueues every batch without waiting for the device;
``_harvest_iter`` decodes the batches in order, each once its own copies
to the host have landed.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from alphadia_torch.constants.settings import MASS_NEUTRON_AVG
from alphadia_torch.ops.selection import select_candidates_batch, select_candidates_batch_4d
from alphadia_torch.ops.smooth import gaussian_kernel_1d, rt_kernel_sigma
from alphadia_torch.rawdata.diadata import DiaData
from alphadia_torch.search.common import (
    assign_observation_slots,
    host_arrays,
    to_device,
    to_host_async,
    top_k_fragment_order,
)
from alphadia_torch.utils.device import batch_schedule, bucket_window, resolve_device

logger = logging.getLogger(__name__)

CANDIDATE_COLUMNS = {
    "precursor_idx": np.int64,
    "rank": np.uint8,
    "score": np.float32,
    "scan_start": np.int64,
    "scan_center": np.int64,
    "scan_stop": np.int64,
    "frame_start": np.int64,
    "frame_center": np.int64,
    "frame_stop": np.int64,
}


@dataclass
class SelectionConfig:
    """Hyperparameters of candidate selection."""

    rt_tolerance: float = 60.0
    precursor_mz_tolerance: float = 10.0
    fragment_mz_tolerance: float = 15.0
    candidate_count: int = 3
    top_k_fragments: int = 12
    top_k_precursors: int = 3  # isotopes
    exclude_shared_ions: bool = True
    kernel_size: int = 30
    fwhm_rt: float = 5.0
    sigma_scale_rt: float = 0.5
    f_rt: float = 0.99
    center_fraction: float = 0.5
    min_size_rt: int = 3
    max_size_rt: int = 15
    # 4D (ion mobility) extents, in scan bins
    f_mobility: float = 0.99
    min_size_mobility: int = 2
    max_size_mobility: int = 6
    join_close_candidates: bool = True
    join_close_candidates_cycle_threshold: float = 0.6
    peak_cycle_tolerance: int = 3
    # 4D close-peak suppression needs both tolerances to hold
    peak_scan_tolerance: int = 3
    # merge adjacent cycles while the RT window exceeds 512 cycles
    # (pre-calibration searches): k x less XIC work, cells sum
    coarsen_wide_windows: bool = True
    batch_size: int = 16384
    gather_slab: int = 256
    max_ms2_obs: int = 2
    max_ms1_obs: int = 1


def empty_candidates() -> dict:
    return {k: np.array([], dtype=v) for k, v in CANDIDATE_COLUMNS.items()}


class CandidateSelection:
    def __init__(
        self,
        dia_data: DiaData,
        precursor: dict,
        fragment: dict,
        config: SelectionConfig | None = None,
        rt_column: str = "rt_library",
        precursor_mz_column: str = "mz_library",
        fragment_mz_column: str = "mz_library",
        device=None,
    ):
        self.dia = dia_data
        self.precursor = precursor
        self.fragment = fragment
        self.config = config or SelectionConfig()
        self.rt_column = rt_column
        self.precursor_mz_column = precursor_mz_column
        self.fragment_mz_column = fragment_mz_column
        self.device = resolve_device(device)

    def _window_len(self) -> int:
        """Cycle-window length: twice the RT tolerance, at least
        max(32, kernel_size), on the bucket grid."""
        cfg = self.config
        need = int(np.ceil(2.0 * cfg.rt_tolerance / self.dia.cycle_time))
        return bucket_window(max(need, 32, cfg.kernel_size))

    def _prepare_batch_arrays(self) -> dict:
        cfg = self.config
        dia = self.dia
        prec = self.precursor
        frag = self.fragment
        n = len(prec["precursor_idx"])

        mono_mz = prec[self.precursor_mz_column].astype(np.float32)
        charge = prec["charge"].astype(np.int32)
        rt = prec[self.rt_column].astype(np.float32)

        KI = cfg.top_k_precursors
        iso_mz = (
            mono_mz[:, None]
            + np.arange(KI, dtype=np.float32)[None, :] * MASS_NEUTRON_AVG / charge[:, None]
        ).astype(np.float32)

        # fragments: ragged -> padded, cardinality filter, top-k by intensity
        starts = prec["flat_frag_start_idx"].astype(np.int64)
        stops = prec["flat_frag_stop_idx"].astype(np.int64)
        max_len = int((stops - starts).max()) if n else 1
        k_idx = starts[:, None] + np.arange(max_len)[None, :]
        valid = k_idx < stops[:, None]
        k_idx = np.minimum(k_idx, max(len(frag["intensity"]) - 1, 0))
        fmz = frag[self.fragment_mz_column].astype(np.float32)[k_idx]
        fint = frag["intensity"].astype(np.float32)[k_idx]
        if cfg.exclude_shared_ions:
            valid &= frag["cardinality"][k_idx] <= 1
        KF = cfg.top_k_fragments
        if max_len < KF:
            pad_w = KF - max_len
            fmz = np.pad(fmz, ((0, 0), (0, pad_w)))
            fint = np.pad(fint, ((0, 0), (0, pad_w)), constant_values=-1.0)
            valid = np.pad(valid, ((0, 0), (0, pad_w)))
        order = top_k_fragment_order(valid, fint, KF)
        sel_valid = np.take_along_axis(valid, order, axis=1)
        sel_mz = np.where(sel_valid, np.take_along_axis(fmz, order, axis=1), 0.0)

        ms2_slots, ms1_slots, _, _ = assign_observation_slots(
            dia, mono_mz, iso_mz, cfg.max_ms2_obs, cfg.max_ms1_obs
        )
        n_obs2 = ms2_slots.shape[1]
        frag_slot = np.where(
            np.tile(sel_valid, n_obs2), np.repeat(ms2_slots, KF, axis=1), -1
        )
        n_obs1 = ms1_slots.shape[1]

        W = self._window_len()
        center = np.searchsorted(dia.cycle_rt, rt).astype(np.int64)
        cycle_start = np.clip(center - W // 2, 0, max(dia.n_cycles - W, 0))
        return {
            "frag_slot": frag_slot.astype(np.int32),
            "frag_mz": np.tile(sel_mz, n_obs2).astype(np.float32),
            "iso_slot": np.repeat(ms1_slots, KI, axis=1).astype(np.int32),
            "iso_mz": np.tile(iso_mz, n_obs1).astype(np.float32),
            "cycle_start": cycle_start.astype(np.int32),
            "n_valid_fragments": sel_valid.sum(axis=1).astype(np.int32),
            "window_len": W,
        }

    def __call__(self) -> dict:
        """Select candidates for every precursor; returns a column dict."""
        state = self._submit()
        if state is None:
            return empty_candidates()
        frames = [frame for _, frame in self._harvest_iter(state)]
        out = {k: np.concatenate([f[k] for f in frames]) for k in CANDIDATE_COLUMNS}
        logger.info(
            "Candidate selection: %d candidates for %d precursors (window %d cycles%s)",
            len(out["precursor_idx"]), state["n"], state["window_len"],
            f", {self.dia.n_scan_bins} scan bins" if state["use_4d"] else "",
        )
        return out

    def _submit(self) -> dict | None:
        """Prepare the query arrays, upload them and enqueue every batch;
        each batch's outputs go to pinned host buffers by asynchronous
        copies followed by an event. Nothing here waits for the device.
        Returns the state that :meth:`_harvest_iter` decodes, or None for
        an empty library."""
        cfg = self.config
        dia = self.dia
        n = len(self.precursor["precursor_idx"])
        if n == 0:
            return None
        arrays = self._prepare_batch_arrays()
        W = arrays["window_len"]

        # wide windows: merge `stride` adjacent cycles per cell (a strided
        # cell_start view of the same store); peaks and extents map back to
        # fine cycles below, and scoring re-extracts at full resolution
        stride = 1
        if cfg.coarsen_wide_windows:
            while W // stride > 512:
                stride *= 2
        dev = dia.device_arrays(stride, self.device)
        n_cycles_dev = dev["n_cycles"]
        if stride > 1:
            W = bucket_window(max(-(-arrays["window_len"] // stride), 32, cfg.kernel_size))
            arrays["cycle_start"] = np.clip(
                arrays["cycle_start"] // stride, 0, max(n_cycles_dev - W, 0)
            ).astype(np.int32)
            logger.info(
                "selection: coarsened %d-cycle window to %d (stride %d)",
                arrays["window_len"], W, stride,
            )

        sigma = rt_kernel_sigma(cfg.fwhm_rt, cfg.sigma_scale_rt, dia.cycle_time * stride)
        kernel = to_device(gaussian_kernel_1d(cfg.kernel_size, sigma), self.device)
        # size and tolerance knobs are in cycle units: scale to coarse cells
        min_rt_k = max(1, cfg.min_size_rt // stride)
        max_rt_k = max(min_rt_k + 1, -(-cfg.max_size_rt // stride))
        static_kw = dict(
            n_cycles=n_cycles_dev,
            n_bins=dia.n_bins,
            bin_mz_min=dia.bin_mz_min,
            bin_width=dia.coarse_bin_width,
            slab=cfg.gather_slab,
            window_len=W,
            kernel_size=cfg.kernel_size,
            candidate_count=cfg.candidate_count,
            min_size_rt=min_rt_k,
            max_size_rt=max_rt_k,
            f_rt=cfg.f_rt,
            center_fraction=cfg.center_fraction,
            join_close_candidates=cfg.join_close_candidates,
            join_cycle_threshold=cfg.join_close_candidates_cycle_threshold,
            peak_cycle_tolerance=max(1, cfg.peak_cycle_tolerance // stride),
        )
        use_4d = dia.has_mobility and dia.n_scan_bins > 1
        if use_4d:
            # the score map keeps the scan axis: the dense [B, Q, S, W]
            # intermediates are S times the 3D footprint, so cap the batch.
            # The strided cell_start alone coarsens: cells sum `stride` cycles
            select = select_candidates_batch_4d
            peaks = (dev["peak_mz"], dev["peak_intensity"], dev["peak_scanbin"])
            cap = min(cfg.batch_size, 4096)
            static_kw.update(
                n_scan_bins=dia.n_scan_bins,
                min_size_mobility=cfg.min_size_mobility,
                max_size_mobility=cfg.max_size_mobility,
                f_mobility=cfg.f_mobility,
                peak_scan_tolerance=cfg.peak_scan_tolerance,
            )
        else:
            select = select_candidates_batch
            peaks = (dev["peak_store"],)
            cap = cfg.batch_size
            static_kw.update(cycle_stride=stride)
        keys = ("frag_slot", "frag_mz", "iso_slot", "iso_mz", "cycle_start", "n_valid_fragments")
        batch_dev = {k: to_device(arrays[k], self.device) for k in keys}

        pending = []
        for b0, bsz in batch_schedule(n, cap):
            b1 = min(b0 + bsz, n)
            sl = {k: v[b0:b1] for k, v in batch_dev.items()}
            res = select(
                *peaks, dev["cell_start"],
                sl["frag_slot"], sl["frag_mz"], sl["iso_slot"], sl["iso_mz"],
                sl["cycle_start"], kernel,
                cfg.fragment_mz_tolerance, cfg.precursor_mz_tolerance,
                sl["n_valid_fragments"], **static_kw,
            )
            pending.append((b0, to_host_async(res)))
        return {
            "pending": pending,
            "stride": stride,
            "use_4d": use_4d,
            "n": n,
            "window_len": W,
            # the JAX driver ships scores as float16 when every value fits
            "f16_scores": (
                dia.n_cycles < 32000
                and cfg.candidate_count <= 16
                and (not use_4d or dia.n_scan_bins < 32000)
            ),
        }

    def _harvest_iter(self, state: dict):
        """Yield ``(b0, candidates)`` per batch in batch order, each as soon
        as its own copies have landed: a consumer (``search/pipelined.py``)
        enqueues scoring while later batches still run."""
        for b0, pending in state["pending"]:
            yield b0, self._decode(b0, host_arrays(pending), state["stride"], state["f16_scores"])

    def _decode(self, b0: int, r: dict, stride: int, f16_scores: bool) -> dict:
        rows, cands = np.nonzero(r["valid"])
        score = r["score"][rows, cands]
        if f16_scores:
            score = score.astype(np.float16).astype(np.float32)
        n_c = len(rows)
        precursor_idx = self.precursor["precursor_idx"].astype(np.int64)
        if "scan_center" in r:
            scans = {k: r[k][rows, cands].astype(np.int64) for k in ("scan_start", "scan_center", "scan_stop")}
        else:  # 3D: the one dummy scan [0, 1)
            scans = dict(
                scan_start=np.zeros(n_c, np.int64), scan_center=np.zeros(n_c, np.int64),
                scan_stop=np.ones(n_c, np.int64),
            )
        return {
            "precursor_idx": precursor_idx[b0 + rows],
            "rank": r["rank"][rows, cands].astype(np.uint8),
            "score": score,
            **scans,
            # coarse cells map back to fine cycles (stride 1 is the identity)
            "frame_start": r["cycle_start"][rows, cands].astype(np.int64) * stride,
            "frame_center": np.minimum(
                r["cycle_center"][rows, cands].astype(np.int64) * stride + stride // 2,
                self.dia.n_cycles - 1,
            ),
            "frame_stop": np.minimum(
                r["cycle_stop"][rows, cands].astype(np.int64) * stride, self.dia.n_cycles
            ),
        }
