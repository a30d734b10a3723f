"""The transfer library: consensus training data from a search's runs.

- ``build_run_speclib``: one run's target PSMs with ``run`` and the
  coordinates ``rt_obs`` / ``mz_obs`` / ``mobility_obs`` (observed >
  calibrated > library), and the fragments of those precursors;
- ``accumulate_transfer_library``: every run folder's ``psm.parquet`` with
  its ``frag.transfer.parquet`` (``frag.parquet`` where absent); the
  ``top_k_samples`` runs of lowest ``proba`` per precursor (keyed on
  ``mod_seq_charge_hash`` where present); RT normalised per run to [0, 1]
  by its 1st and 99th percentiles (``norm_delta_max``; else min and max);
  the MS2 QC: the PSMs whose median fragment correlation exceeds
  ``precursor_correlation_cutoff``, and their fragments whose correlation
  is at least ``fragment_correlation_ratio`` times that median.

The JAX package's ``outputs/transfer_library.py`` with column dicts for its
frames: pandas' ``groupby``/``merge`` as numpy with the same row order.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from alphadia_torch.constants.keys import SearchStepFiles
from alphadia_torch.utils.frame import concat, copy_frame, n_rows, take
from alphadia_torch.utils.parquet import read_parquet

logger = logging.getLogger(__name__)


def build_run_speclib(psm_df: dict, frag_df: dict, run: str) -> tuple[dict, dict]:
    """One run's observed library rows (targets only)."""
    psm = take(psm_df, psm_df["decoy"] == 0) if "decoy" in psm_df else copy_frame(psm_df)
    psm["run"] = np.full(n_rows(psm), run, dtype=object)
    for prop in ("rt", "mz", "mobility"):
        for source in (f"{prop}_observed", f"{prop}_calibrated", f"{prop}_library"):
            if source in psm:
                psm[f"{prop}_obs"] = np.array(psm[source], copy=True)
                break
    frag = take(frag_df, np.isin(frag_df["precursor_idx"], psm["precursor_idx"]))
    frag["run"] = np.full(n_rows(frag), run, dtype=object)
    return psm, frag


def _run_precursor_key(run: np.ndarray, precursor_idx: np.ndarray, runs: np.ndarray) -> np.ndarray:
    """(run, precursor_idx) as one int64: the run's place in ``runs``
    above the 32-bit precursor index."""
    return np.searchsorted(runs, run.astype(str)).astype(np.int64) << 32 | np.asarray(precursor_idx, np.int64)


def _group_median(key: np.ndarray, values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(the distinct keys, the median of ``values`` for each), as pandas'
    ``groupby(key)[values].median()``: NaN skipped, NaN for a group of NaN
    only."""
    values = np.asarray(values)
    groups, codes = np.unique(key, return_inverse=True)
    out = np.full(len(groups), np.nan)
    ok = ~np.isnan(values)
    order = np.lexsort((values[ok], codes[ok]))
    c, v = codes[ok][order], values[ok][order].astype(np.float64)
    present, first, counts = np.unique(c, return_index=True, return_counts=True)
    out[present] = (v[first + (counts - 1) // 2] + v[first + counts // 2]) / 2.0
    return groups, out


def _first_k_per_group(key: np.ndarray, k: int) -> np.ndarray:
    """The rows among the first ``k`` of their key, as pandas'
    ``groupby(key).head(k)``."""
    _, codes = np.unique(key, return_inverse=True)
    order = np.argsort(codes, kind="stable")
    sorted_codes = codes[order]
    starts = np.searchsorted(sorted_codes, sorted_codes)
    keep = np.zeros(len(key), bool)
    keep[order] = np.arange(len(key)) - starts < k
    return keep


def accumulate_transfer_library(
    folder_list: list,
    top_k_samples: int = 3,
    precursor_correlation_cutoff: float = 0.5,
    fragment_correlation_ratio: float = 0.75,
    norm_delta_max: bool = True,
) -> tuple[dict, dict]:
    """(precursor frame, fragment frame) of the consensus transfer library;
    two empty frames where no run folder holds its files."""
    psms, frags = [], []
    for folder in folder_list:
        folder = Path(folder)
        psm_path = folder / SearchStepFiles.PSM_FILE_NAME
        frag_path = folder / SearchStepFiles.FRAG_TRANSFER_FILE_NAME
        if not frag_path.exists():
            frag_path = folder / SearchStepFiles.FRAG_FILE_NAME
        if not psm_path.exists() or not frag_path.exists():
            continue
        p, f = build_run_speclib(read_parquet(psm_path), read_parquet(frag_path), folder.name)
        psms.append(p)
        frags.append(f)
    if not psms:
        return {}, {}
    psm, frag = concat(psms), concat(frags)

    # the top-k runs of each precursor, lowest proba first (pandas' sort of
    # one column: numpy's quicksort of the values, NaN last)
    if "proba" in psm:
        proba = psm["proba"]
        nan = np.isnan(proba)
        rows = np.nonzero(~nan)[0]
        psm = take(psm, np.concatenate([rows[proba[rows].argsort(kind="quicksort")], np.nonzero(nan)[0]]))
        key = psm["mod_seq_charge_hash" if "mod_seq_charge_hash" in psm else "precursor_idx"]
        psm = take(psm, _first_k_per_group(key, top_k_samples))

    # RT normalised to [0, 1] per run
    rts = psm["rt_obs"].astype(np.float64)
    norm = np.zeros_like(rts)
    run_of = psm["run"].astype(str)
    for run in np.unique(run_of):
        idx = np.nonzero(run_of == run)[0]
        r = rts[idx]
        if norm_delta_max and len(r) > 2:
            lo, hi = np.percentile(r, [1, 99])
        else:
            lo, hi = r.min(), r.max()
        norm[idx] = np.clip((r - lo) / max(hi - lo, 1e-9), 0, 1)
    psm["rt_norm"] = norm.astype(np.float32)

    # the MS2 QC by the median fragment correlation of each (run, precursor)
    runs = np.unique(np.concatenate([run_of, frag["run"].astype(str)]))
    psm_key = _run_precursor_key(psm["run"], psm["precursor_idx"], runs)
    frag_key = _run_precursor_key(frag["run"], frag["precursor_idx"], runs)
    groups, median = _group_median(frag_key, frag["correlation"])
    median = median.astype(frag["correlation"].dtype)
    for frame, key in ((frag, frag_key), (psm, psm_key)):
        pos = np.minimum(np.searchsorted(groups, key), max(len(groups) - 1, 0))
        hit = (groups[pos] == key) if len(groups) else np.zeros(len(key), bool)
        frame["corr_median"] = np.where(hit, median[pos] if len(groups) else np.nan, np.nan).astype(median.dtype)
    n_before = n_rows(psm)
    keep_psm = psm["corr_median"] > precursor_correlation_cutoff
    psm = take(psm, keep_psm)
    keep_frag = (frag["correlation"] >= fragment_correlation_ratio * frag["corr_median"]) & np.isin(
        frag_key, psm_key[keep_psm]
    )
    frag = take(frag, keep_frag)
    logger.log(25, "Transfer library: %d PSMs (%d removed by MS2 QC), %d fragments", n_rows(psm),
               n_before - n_rows(psm), n_rows(frag))
    return psm, frag
