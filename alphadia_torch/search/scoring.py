"""Host driver of candidate scoring.

Per-precursor library arrays (top-k fragments, isotopes, observation slots,
quadrupole windows) are built once on the host and uploaded; each batch of
candidates gathers its library rows on the device by index and runs
``ops/scoring.score_candidates_batch``. Produces the PSM column dict (46
named features, precursor metadata, derived columns) and the per-fragment
column dict. On ion-mobility data each candidate also carries its scan
window, the batch is capped at 4096, and the scan centre of mass and the
window's width become ``mobility_observed`` and ``base_width_mobility``.

Each chunk of candidates is enqueued with its copies to pinned host
buffers (``_dispatch``) before any is read back (``_harvest``), so the host
never waits for one chunk before enqueuing the next. With several devices
(``devices`` and ``ScoringConfig.mesh_devices``) the library arrays and the
peak store are uploaded once to each, and every chunk is cut into equal
row shards, one per device, each scored on its own device
(``parallel.shard_ops.run_on_devices``); the PSMs equal one device's.

Under a profiler the phases are spans (``utils/profiling``):
``scoring.library`` (the library arrays and their upload),
``scoring.geometry`` (the candidates' rows and windows),
``scoring.launch`` (each chunk enqueued) and ``scoring.assemble`` (the
outputs concatenated and assembled, after the waits); and each chunk counts
its cells: ``scoring.cells`` (rows as dispatched times W) and
``scoring.extent_cells`` (each candidate's frames, at most W).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from alphadia_torch.constants.settings import MASS_NEUTRON_AVG
from alphadia_torch.ops.scoring import round_transport, score_candidates_batch
from alphadia_torch.parallel.mesh import pad_to_multiple, shard_bounds
from alphadia_torch.parallel.shard_ops import run_on_devices
from alphadia_torch.rawdata.diadata import DiaData
from alphadia_torch.search.common import (
    assign_observation_slots,
    data_parallel_devices,
    host_rows,
    to_device,
    to_host_async,
    top_k_fragment_order,
)
from alphadia_torch.utils.device import batch_schedule, bucket_window, resolve_device
from alphadia_torch.utils.profiling import count, enabled, span

logger = logging.getLogger(__name__)

# order matches the feature indices of ops/scoring.py
FEATURE_COLUMNS = [
    "base_width_mobility", "base_width_rt", "rt_observed", "mobility_observed",
    "mono_ms1_intensity", "top_ms1_intensity", "sum_ms1_intensity",
    "weighted_ms1_intensity", "weighted_mass_deviation", "weighted_mass_error",
    "mz_observed", "mono_ms1_height", "top_ms1_height", "sum_ms1_height",
    "weighted_ms1_height", "isotope_intensity_correlation",
    "isotope_height_correlation", "n_observations", "intensity_correlation",
    "height_correlation", "intensity_fraction", "height_fraction",
    "intensity_fraction_weighted", "height_fraction_weighted",
    "mean_observation_score", "sum_b_ion_intensity", "sum_y_ion_intensity",
    "diff_b_y_ion_intensity", "f_masked", "fragment_scan_correlation",
    "template_scan_correlation", "fragment_frame_correlation",
    "top3_frame_correlation", "template_frame_correlation",
    "top3_b_ion_correlation", "n_b_ions", "top3_y_ion_correlation", "n_y_ions",
    "cycle_fwhm", "mobility_fwhm", "delta_frame_peak", "top_3_ms2_mass_error",
    "mean_ms2_mass_error", "n_overlapping", "mean_overlapping_intensity",
    "mean_overlapping_mass_error",
]

# per-candidate geometry that each batch slices
GEO_KEYS = ("rows", "frame_center", "frame_start", "frame_stop", "scan_lo", "scan_hi", "mobility_width")
# library arrays that the device gathers per candidate
LIB_KEYS = (
    "frag_mz", "frag_valid", "frag_intensity", "frag_type", "frag_position",
    "iso_mz", "iso_intensity", "ms2_slot", "ms1_slot", "win_lo", "win_hi",
)
# the JAX driver ships these library intensities as float16 when they fit
_F16_KEYS = ("frag_intensity", "iso_intensity")
# per-fragment outputs copied back to the host
_FRAG_KEEP = ("mass_error", "height", "intensity", "correlation", "valid", "obs_intensity", "scan_com")

# precursor columns carried into the PSM table when present
PRECURSOR_CARRY_COLUMNS = [
    "elution_group_idx", "decoy", "channel", "charge", "mz_library",
    "rt_library", "mobility_library", "flat_frag_start_idx",
    "flat_frag_stop_idx", "proteins", "genes", "sequence", "mods",
    "mod_sites", "mod_seq_hash", "mod_seq_charge_hash", "nAA",
    "i_0", "i_1", "i_2", "i_3",
]

FRAGMENT_COLUMNS = [
    "precursor_idx", "rank", "mz_library", "mz", "mz_observed", "height",
    "intensity", "mass_error", "correlation", "position", "number", "type",
    "charge", "loss_type",
]


def window_bucket(geo: dict, a: int, b: int) -> int:
    """Scoring window bucket W of candidates [a, b): the widest extent on
    either side of a centre, as ``2 * half + 1`` cycles, at least 16."""
    if b <= a:
        return 16
    half = np.maximum(
        geo["frame_center"][a:b] - geo["frame_start"][a:b],
        geo["frame_stop"][a:b] - geo["frame_center"][a:b],
    )
    return bucket_window(max(2 * int(half.max()) + 1, 16))


@dataclass
class ScoringConfig:
    precursor_mz_tolerance: float = 10.0
    fragment_mz_tolerance: float = 15.0
    top_k_fragments: int = 12
    top_k_isotopes: int = 3
    exclude_shared_ions: bool = True
    quant_window: int = 3
    quant_all: bool = True
    experimental_xic: bool = True
    collect_fragments: bool = True
    # emit every library fragment slot (zeros where unobserved), not only
    # the observed ones
    collect_unobserved_fragments: bool = False
    batch_size: int = 16384
    gather_slab: int = 256
    max_ms2_obs: int = 2
    max_ms1_obs: int = 1
    quad_sigma: tuple = (0.2, 0.2)
    quad_delta_mu: tuple = (0.0, 0.0)
    # 'bfloat16' runs the dense intensity chains in bfloat16; m/z and
    # mass-error math stays float32 either way
    compute_dtype: str = "float32"
    # cap on the devices that each chunk is split across (tpu.mesh_devices)
    mesh_devices: int | None = None


def empty_psms() -> dict:
    return {c: np.array([], np.float32) for c in FEATURE_COLUMNS + ["precursor_idx", "rank", "score"]}


def empty_fragments() -> dict:
    return {c: np.array([], np.float32) for c in FRAGMENT_COLUMNS}


class CandidateScoring:
    def __init__(
        self,
        dia_data: DiaData,
        precursor: dict,
        fragment: dict,
        config: ScoringConfig | None = None,
        rt_column: str = "rt_library",
        precursor_mz_column: str = "mz_library",
        fragment_mz_column: str = "mz_library",
        device=None,
        devices=None,
    ):
        self.dia = dia_data
        self.precursor = precursor
        self.fragment = fragment
        self.config = config or ScoringConfig()
        self.rt_column = rt_column
        self.precursor_mz_column = precursor_mz_column
        self.fragment_mz_column = fragment_mz_column
        # ``devices``: the devices a chunk may be split across (default: the one device)
        self.devices = [resolve_device(d) for d in devices] if devices else [resolve_device(device)]
        self.device = self.devices[0]
        self._lib_arrays: dict | None = None
        self._row_order: tuple | None = None

    def _library_arrays(self) -> dict:
        """Per-precursor scoring inputs, built once over the library rows."""
        if self._lib_arrays is not None:
            return self._lib_arrays
        with span("scoring.library"):
            self._lib_arrays = self._build_library_arrays()
        return self._lib_arrays

    def _build_library_arrays(self) -> dict:
        cfg = self.config
        prec = self.precursor
        frag = self.fragment
        mono_mz = prec[self.precursor_mz_column].astype(np.float32)
        charge = prec["charge"].astype(np.int32)
        n = len(mono_mz)

        KI = cfg.top_k_isotopes
        iso_cols = [c for c in (f"i_{k}" for k in range(KI)) if c in prec]
        if iso_cols:
            iso_int = np.stack([prec[c] for c in iso_cols], axis=1).astype(np.float32)
            if iso_int.shape[1] < KI:
                iso_int = np.pad(iso_int, ((0, 0), (0, KI - iso_int.shape[1])))
        else:
            iso_int = np.tile(np.array([[1.0, 0.5, 0.25]], np.float32)[:, :KI], (n, 1))
        iso_mz = (
            mono_mz[:, None]
            + np.arange(KI, dtype=np.float32)[None, :] * MASS_NEUTRON_AVG / charge[:, None]
        ).astype(np.float32)

        # fragments: the same top-k subset as selection
        starts = prec["flat_frag_start_idx"].astype(np.int64)
        stops = prec["flat_frag_stop_idx"].astype(np.int64)
        max_len = max(int((stops - starts).max()) if n else 1, cfg.top_k_fragments)
        k_idx = starts[:, None] + np.arange(max_len)[None, :]
        valid = k_idx < stops[:, None]
        k_idx = np.minimum(k_idx, max(len(frag["intensity"]) - 1, 0))
        fint = frag["intensity"].astype(np.float32)[k_idx]
        if cfg.exclude_shared_ions:
            valid &= frag["cardinality"][k_idx] <= 1
        order = top_k_fragment_order(valid, fint, cfg.top_k_fragments)

        def takef(col, dtype):
            return np.take_along_axis(frag[col].astype(dtype)[k_idx], order, axis=1)

        sel_valid = np.take_along_axis(valid, order, axis=1)
        out = {
            "frag_mz": np.where(sel_valid, takef(self.fragment_mz_column, np.float32), 0.0).astype(np.float32),
            "frag_valid": sel_valid,
            "frag_intensity": np.where(sel_valid, takef("intensity", np.float32), 0.0).astype(np.float32),
            "frag_type": takef("type", np.int32),
            "frag_position": takef("position", np.int32),
            "frag_number": takef("number", np.int32),
            "frag_charge": takef("charge", np.int32),
            "frag_loss_type": takef("loss_type", np.int32),
            "frag_mz_library": np.where(sel_valid, takef("mz_library", np.float32), 0.0).astype(np.float32),
        }
        ms2_slots, ms1_slots, win_lo, win_hi = assign_observation_slots(
            self.dia, mono_mz, iso_mz, cfg.max_ms2_obs, cfg.max_ms1_obs
        )
        out.update(
            iso_mz=iso_mz,
            iso_intensity=iso_int.astype(np.float32),
            ms2_slot=ms2_slots.astype(np.int32),
            ms1_slot=ms1_slots.astype(np.int32),
            win_lo=win_lo,
            win_hi=win_hi,
        )
        return out

    def _batch_cap(self) -> int:
        """Scoring batch cap: 4D scan-profile extraction is S times heavier."""
        dia = self.dia
        if dia.has_mobility and dia.n_scan_bins > 1:
            return min(self.config.batch_size, 4096)
        return self.config.batch_size

    def _mesh(self) -> list | None:
        """The devices each chunk is split across, or None for one."""
        return data_parallel_devices(self.config.mesh_devices, self.config.batch_size, self.devices)

    def _upload_lib(self, device=None) -> tuple[dict, dict]:
        """Upload the per-precursor library arrays once to ``device``
        (default: the driver's), without waiting. Returns ``(lib_host,
        lib_dev)``."""
        lib = self._library_arrays()
        lib_dev = {}
        with span("scoring.library"):
            for k in LIB_KEYS:
                a = lib[k]
                if k in _F16_KEYS and (not a.size or max(-float(a.min()), float(a.max())) <= 60000.0):
                    a = a.astype(np.float16).astype(np.float32)
                lib_dev[k] = to_device(a, self.device if device is None else device)
        return lib, lib_dev

    def _row_of(self, precursor_idx: np.ndarray) -> np.ndarray:
        """Library row of each precursor index."""
        if self._row_order is None:
            pidx = self.precursor["precursor_idx"].astype(np.int64)
            self._row_order = pidx, np.argsort(pidx, kind="stable")
        pidx, order = self._row_order
        return order[np.searchsorted(pidx, precursor_idx.astype(np.int64), sorter=order)]

    def _candidate_geometry(self, cand: dict) -> dict:
        """Per-candidate precursor row and elution window geometry."""
        with span("scoring.geometry"):
            rows = self._row_of(cand["precursor_idx"])
            frame_center = cand["frame_center"].astype(np.int32)
            frame_start = cand["frame_start"].astype(np.int32)
            frame_stop = cand["frame_stop"].astype(np.int32)
            # the candidate's scan window; the one dummy scan [0, 1) on 3D data
            dia = self.dia
            n = len(frame_center)
            if dia.has_mobility and "scan_start" in cand:
                S = dia.n_scan_bins
                scan_lo = np.clip(cand["scan_start"].astype(np.int64), 0, S - 1).astype(np.int32)
                scan_hi = np.clip(cand["scan_stop"].astype(np.int64), 1, S).astype(np.int32)
                scan_hi = np.maximum(scan_hi, scan_lo + 1)
                mv = np.asarray(dia.mobility_values, np.float32)
                mobility_width = np.abs(mv[np.clip(scan_hi - 1, 0, S - 1)] - mv[scan_lo]).astype(np.float32)
            else:
                scan_lo = np.zeros(n, np.int32)
                scan_hi = np.ones(n, np.int32)
                mobility_width = np.zeros(n, np.float32)
            geo = {
                "rows": rows.astype(np.int64),
                "frame_center": frame_center,
                "frame_start": frame_start,
                "frame_stop": frame_stop,
                "scan_lo": scan_lo,
                "scan_hi": scan_hi,
                "mobility_width": mobility_width,
            }
            geo["window_len"] = window_bucket(geo, 0, n)
            return geo

    def _candidate_arrays(self, cand: dict) -> dict:
        """The per-candidate expansion on the host: the library arrays
        gathered by each candidate's row, with its geometry. Only the debug
        plots read it (``search/plotting.debug_candidates``); the drivers
        ship the library and the geometry and gather on the device."""
        lib = self._library_arrays()
        geo = self._candidate_geometry(cand)
        out = {k: v[geo["rows"]] for k, v in lib.items()}
        out.update(geo)
        return out

    @staticmethod
    def _geo_chunk(geo: dict, b0: int, b1: int) -> dict:
        """The geometry of candidates [b0, b1)."""
        return {k: geo[k][b0:b1] for k in GEO_KEYS}

    def _dispatch(self, devices: list, devs: list, lib_devs: list, geo: dict, a: int, b: int, W: int):
        """Enqueue the scoring of candidates [a, b) with window bucket ``W``
        (feature values do not depend on it): their geometry cut into one
        equal row shard per device, each scored on its device against that
        device's peak store and library arrays. Returns ``(b - a, the
        shards' pending copies)`` for :meth:`_harvest`."""
        with span("scoring.launch"):
            chunk = {k: pad_to_multiple(v, len(devices)) for k, v in self._geo_chunk(geo, a, b).items()}
            if enabled():
                count("scoring.cells", len(chunk["rows"]) * W)
                extent = geo["frame_stop"][a:b].astype(np.int64) - geo["frame_start"][a:b]
                count("scoring.extent_cells", np.clip(extent, 0, W).sum())
            bounds = shard_bounds(len(chunk["rows"]), len(devices))
            return b - a, run_on_devices(
                devices,
                lambda i, _device: self._dispatch_chunk(
                    devs[i], lib_devs[i], {k: v[bounds[i][0]:bounds[i][1]] for k, v in chunk.items()}, W
                ),
            )

    def _dispatch_chunk(self, dev: dict, lib_dev: dict, chunk: dict, W: int):
        """Enqueue the scoring of one geometry chunk on the device that
        ``dev`` lies on and the copies of its outputs to the host; returns
        the pending copies."""
        cfg = self.config
        dia = self.dia
        gd = {k: to_device(v, dev["cell_start"].device) for k, v in chunk.items()}
        g = {k: v.index_select(0, gd["rows"]) for k, v in lib_dev.items()}
        features, valid, frag_out = score_candidates_batch(
            dev["peak_store"], dev["cell_start"], dev["cycle_rt"],
            g["frag_mz"], g["frag_valid"], g["frag_intensity"], g["frag_type"],
            g["frag_position"], g["iso_mz"], g["iso_intensity"],
            g["ms2_slot"], g["ms1_slot"], g["win_lo"], g["win_hi"],
            cfg.quad_sigma, cfg.quad_delta_mu,
            gd["frame_center"], gd["frame_start"], gd["frame_stop"],
            cfg.fragment_mz_tolerance, cfg.precursor_mz_tolerance,
            scan_lo=gd["scan_lo"], scan_hi=gd["scan_hi"], mobility_width=gd["mobility_width"],
            n_cycles=dev["n_cycles"],
            n_bins=dia.n_bins,
            bin_mz_min=dia.bin_mz_min,
            bin_width=dia.coarse_bin_width,
            n_scan_bins=dia.n_scan_bins if dia.has_mobility else 1,
            slab=cfg.gather_slab,
            window_len=W,
            quant_window=cfg.quant_window,
            quant_all=cfg.quant_all,
            experimental_xic=cfg.experimental_xic,
            compute_dtype=cfg.compute_dtype,
        )
        features, frag_out = round_transport(features, frag_out)
        return to_host_async({"features": features, "psm_valid": valid, **{k: frag_out[k] for k in _FRAG_KEEP}})

    def _harvest(self, pending: list, cand: dict, lib: dict, geo: dict) -> tuple[dict, dict]:
        """Read the chunks' outputs in dispatch order, each once its own
        copies have landed, and assemble the (psm, fragment) column dicts.
        ``pending`` (:meth:`_dispatch`'s) covers ``cand`` and ``geo`` in order."""
        parts = [host_rows(p, n_rows) for n_rows, p in pending]
        with span("scoring.assemble"):
            features = np.concatenate([p["features"] for p in parts])
            valid = np.concatenate([p["psm_valid"] for p in parts])
            frag_out = {k: np.concatenate([p[k] for p in parts]) for k in _FRAG_KEEP}
            # observed fragment m/z from the rounded mass error and the queried m/z
            fmz = lib["frag_mz"][geo["rows"]]
            frag_out["mz_observed"] = np.where(
                frag_out["valid"] & (frag_out["height"] > 0),
                fmz * (1.0 + frag_out["mass_error"] * 1e-6),
                0.0,
            ).astype(np.float32)
            return self._assemble(cand, lib, geo, features, valid, frag_out)

    def __call__(self, candidates: dict) -> tuple[dict, dict]:
        """Score all candidates. Returns (psm, fragment) column dicts."""
        n = len(candidates["precursor_idx"])
        if n == 0:
            return empty_psms(), empty_fragments()
        devices = self._mesh() or [self.device]
        lib_devs = [self._upload_lib(d)[1] for d in devices]
        lib = self._library_arrays()
        geo = self._candidate_geometry(candidates)
        W = geo["window_len"]
        devs = [self.dia.device_arrays(1, d) for d in devices]
        pending = [
            self._dispatch(devices, devs, lib_devs, geo, b0, min(b0 + bsz, n), W)
            for b0, bsz in batch_schedule(n, self._batch_cap())
        ]
        psm, fragments = self._harvest(pending, candidates, lib, geo)
        logger.info(
            "Candidate scoring: %d/%d candidates scored (window %d cycles)",
            len(psm["precursor_idx"]), n, W,
        )
        return psm, fragments

    def _assemble(self, cand, lib, geo, features, valid, frag_out):
        cfg = self.config
        prec = self.precursor
        keep_rows = np.nonzero(valid)[0]
        rows = geo["rows"][keep_rows]
        psm: dict = {name: features[keep_rows, j] for j, name in enumerate(FEATURE_COLUMNS)}
        for o in range(frag_out["obs_intensity"].shape[1]):
            psm[f"obs_intensity_{o}"] = frag_out["obs_intensity"][keep_rows, o]
            psm[f"obs_win_lo_{o}"] = lib["win_lo"][rows, o]
            psm[f"obs_win_hi_{o}"] = lib["win_hi"][rows, o]
        dia = self.dia
        if dia.has_mobility and dia.n_scan_bins > 1:
            # scan centre of mass (bins) -> mobility; the scan window's width
            S = dia.n_scan_bins
            span = dia.mobility_max - dia.mobility_min
            com = frag_out["scan_com"][keep_rows]
            psm["mobility_observed"] = np.where(
                com > 0, dia.mobility_min + com / S * span, 0.0
            ).astype(np.float32)
            psm["base_width_mobility"] = geo["mobility_width"][keep_rows]
        psm["precursor_idx"] = cand["precursor_idx"][keep_rows]
        psm["rank"] = cand["rank"][keep_rows]
        psm["score"] = (
            cand["score"][keep_rows] if "score" in cand else np.zeros(len(keep_rows), np.float32)
        )
        for col in ("scan_center", "scan_start", "scan_stop", "frame_center", "frame_start", "frame_stop"):
            if col in cand:
                psm[col] = cand[col][keep_rows]
        for c in PRECURSOR_CARRY_COLUMNS:
            if c in prec:
                psm[c] = prec[c][rows]
        psm["delta_rt"] = psm["rt_observed"] - prec[self.rt_column].astype(np.float32)[rows]
        if "sequence" in prec:
            seqs = prec["sequence"].astype(str)
            for aa in ("K", "R", "P"):
                psm[f"n_{aa}"] = np.char.count(seqs, aa).astype(np.float32)[rows]

        if not cfg.collect_fragments:
            return psm, empty_fragments()
        cand_frag_valid = lib["frag_valid"][geo["rows"]]
        obs_mask = frag_out["valid"] & cand_frag_valid
        fv = cand_frag_valid if cfg.collect_unobserved_fragments else obs_mask
        rr, cc = np.nonzero(fv[keep_rows])
        sel = (keep_rows[rr], cc)
        lib_sel = (geo["rows"][sel[0]], sel[1])
        obs_sel = obs_mask[sel]

        def observed(a):
            # unobserved slots carry the kernel's padding values
            return np.where(obs_sel, a[sel], 0.0).astype(np.float32)

        fragments = {
            "precursor_idx": cand["precursor_idx"][keep_rows][rr],
            "rank": cand["rank"][keep_rows][rr],
            "mz_library": lib["frag_mz_library"][lib_sel],
            "mz": lib["frag_mz"][lib_sel],
            "mz_observed": observed(frag_out["mz_observed"]),
            "height": observed(frag_out["height"]),
            "intensity": observed(frag_out["intensity"]),
            "mass_error": observed(frag_out["mass_error"]),
            "correlation": observed(frag_out["correlation"]),
            "position": lib["frag_position"][lib_sel].astype(np.uint8),
            "number": lib["frag_number"][lib_sel].astype(np.uint8),
            "type": lib["frag_type"][lib_sel].astype(np.uint8),
            "charge": lib["frag_charge"][lib_sel].astype(np.uint8),
            "loss_type": lib["frag_loss_type"][lib_sel].astype(np.uint8),
        }
        return psm, fragments
