"""Label-free quantification across runs, on column dicts.

The runs' ``frag.parquet`` rows become ion x run matrices keyed by the
packed ion hash (precursor, number, type, charge, loss type); ions are
filtered by their mean cross-run correlation; then directLFQ-style (run
shifts in log space, then per group ion alignment and median profiles) or
QuantSelect-style (the same with ion quality weights) intensities per
precursor, peptide or protein group.

Row orders follow pandas, since the outputs carry them: the ion union is
the first run's ions in their order, then each further run's new ions in
its order (``pd.concat(axis=1)`` of MultiIndexed frames); ranks within a
group break ties by row order (``rank(method="first")``); groups come in
order of first appearance (``pd.factorize``).
"""

from __future__ import annotations

import logging
import warnings

import numpy as np

from alphadia_torch.utils.frame import factorize, n_rows, take

logger = logging.getLogger(__name__)

DEFAULT_FEATURES = ("intensity", "correlation")
QUANTSELECT_FEATURES = ("intensity", "correlation", "mass_error", "height")


def ion_hash(precursor_idx, number, ftype, charge, loss_type) -> np.ndarray:
    """Pack ion identity into int64."""
    return (
        np.asarray(precursor_idx, dtype=np.int64)
        + (np.asarray(number, dtype=np.int64) << 32)
        + (np.asarray(ftype, dtype=np.int64) << 40)
        + (np.asarray(charge, dtype=np.int64) << 48)
        + (np.asarray(loss_type, dtype=np.int64) << 56)
    )


def _missing_filled(values: np.ndarray, present: np.ndarray, n: int, slots: np.ndarray) -> np.ndarray:
    """``values`` placed at ``slots`` of ``n`` rows, NaN elsewhere (float
    columns keep their dtype; others become float64 where a row is
    missing, as a pandas reindex does)."""
    dtype = values.dtype if values.dtype.kind == "f" or present.all() else np.float64
    out = np.full(n, np.nan, dtype) if not present.all() else np.empty(n, dtype)
    out[slots] = values
    return out


def accumulate_frag_df(run_frames: dict[str, dict], columns: tuple[str, ...] = DEFAULT_FEATURES) -> dict[str, dict]:
    """{feature: {ion, precursor_idx, run1, run2, ...}} over the union of
    the runs' ions."""
    per_run = []
    for run, df in run_frames.items():
        h = ion_hash(df["precursor_idx"], df["number"], df["type"], df["charge"], df["loss_type"])
        _, first = np.unique(h, return_index=True)
        first = np.sort(first)
        per_run.append((run, h[first], {c: np.asarray(df[c])[first] for c in ("precursor_idx", *columns)}))

    all_ions = np.concatenate([ions for _, ions, _ in per_run])
    all_prec = np.concatenate([cols["precursor_idx"] for _, _, cols in per_run])
    _, first = np.unique(all_ions, return_index=True)
    first = np.sort(first)
    union, union_prec = all_ions[first], all_prec[first]
    order = np.argsort(union, kind="stable")
    n = len(union)

    out = {c: {"ion": union, "precursor_idx": union_prec} for c in columns}
    for run, ions, cols in per_run:
        slots = order[np.searchsorted(union, ions, sorter=order)]
        present = np.zeros(n, bool)
        present[slots] = True
        for c in columns:
            out[c][run] = _missing_filled(cols[c], present, n, slots)
    return out


def _row_nanmean(mat: np.ndarray) -> np.ndarray:
    """pandas' ``DataFrame.mean(axis=1)``: NaN skipped, summed and divided
    in the columns' float dtype, NaN where a row has no value."""
    nan = np.isnan(mat)
    count = (~nan).sum(axis=1).astype(mat.dtype)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = np.where(nan, 0, mat).sum(axis=1, dtype=mat.dtype) / count
    mean[count == 0] = np.nan
    return mean


def _run_matrix(df: dict, run_columns: list[str], dtype=None) -> np.ndarray:
    cols = [np.asarray(df[c]) for c in run_columns]
    if dtype is None:
        dtype = np.result_type(*cols) if cols else np.float64
        if dtype.kind != "f":
            dtype = np.float64
    return np.stack([c.astype(dtype) for c in cols], axis=1) if cols else np.zeros((0, 0), dtype)


def filter_frag_df(
    intensity_df: dict,
    corr_df: dict,
    min_correlation: float = 0.5,
    top_n: int = 3,
    group_column: str = "precursor_idx",
    group_keys=None,
) -> tuple[dict, dict, np.ndarray]:
    """Keep the ions in the top ``top_n`` by mean correlation within their
    group, or above ``min_correlation``. ``group_keys`` (one per row)
    replace ``group_column`` (the quant level's groups). Returns
    (intensity, correlation, keep mask)."""
    run_cols = [c for c in corr_df if c not in ("ion", group_column, "precursor_idx")]
    mean_corr = _row_nanmean(_run_matrix(corr_df, run_cols))
    groups = np.asarray(group_keys) if group_keys is not None else np.asarray(corr_df[group_column])
    codes = factorize(groups)
    ranked = ~np.isnan(mean_corr)
    rank = np.full(len(mean_corr), np.nan)
    idx = np.nonzero(ranked)[0]
    order = idx[np.lexsort((idx, -mean_corr[idx], codes[idx]))]
    if len(order):
        sorted_codes = codes[order]
        starts = np.r_[0, np.nonzero(np.diff(sorted_codes))[0] + 1]
        pos = np.arange(len(order)) - np.repeat(starts, np.diff(np.r_[starts, len(order)]))
        rank[order] = pos + 1
    with np.errstate(invalid="ignore"):
        mask = (rank <= top_n) | (mean_corr > min_correlation)
    return take(intensity_df, mask), take(corr_df, mask), mask


def normalize_samples(log_mat: np.ndarray, num_samples: int | None = None) -> np.ndarray:
    """Shift each run (column) so that its median difference to the first
    column vanishes; ``num_samples`` caps the ions that estimate the shifts
    (the most complete, most intense rows)."""
    est = log_mat
    if num_samples is not None and len(log_mat) > num_samples:
        completeness = np.isfinite(log_mat).sum(axis=1).astype(np.float64)
        completeness += np.nan_to_num(np.nanmean(log_mat, axis=1)) * 1e-6
        top = np.argsort(completeness, kind="stable")[::-1][:num_samples]
        est = log_mat[top]
    n_runs = log_mat.shape[1]
    shifts = np.zeros(n_runs)
    ref = est[:, 0]
    for j in range(1, n_runs):
        both = np.isfinite(ref) & np.isfinite(est[:, j])
        if both.sum() >= 2:
            shifts[j] = np.nanmedian(ref[both] - est[both, j])
    return log_mat + shifts[None, :]


def estimate_group_intensity(log_mat: np.ndarray) -> np.ndarray:
    """Per-run intensity of a group from its ions x runs log2 matrix: ion
    offsets (row medians) removed, the column median of the aligned ions,
    anchored at the median ion level."""
    if log_mat.size == 0:
        return np.full(log_mat.shape[1], np.nan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN rows are expected
        row_med = np.nanmedian(log_mat, axis=1, keepdims=True)
        centered = log_mat - row_med
        profile = np.nanmedian(centered, axis=0)
        level = np.nanmedian(row_med)
    return profile + level


def _groups_in_order(keys: np.ndarray):
    """(first key, rows) of each group, groups in order of first appearance."""
    codes = factorize(keys)
    order = np.argsort(codes, kind="stable")
    boundaries = np.nonzero(np.diff(codes[order]) != 0)[0] + 1
    starts = np.concatenate([[0], boundaries])
    stops = np.concatenate([boundaries, [len(order)]])
    for a, b in zip(starts, stops):
        if b > a:
            yield keys[order[a]], order[a:b]


def _lfq_frame(keys: np.ndarray, rows: list, run_columns: list[str]) -> dict:
    vals = np.array([r[1] for r in rows], np.float64).reshape(len(rows), len(run_columns))
    group = np.array([r[0] for r in rows], dtype=keys.dtype) if rows else np.array([], keys.dtype)
    out = {"group": group}
    for j, c in enumerate(run_columns):
        out[c] = vals[:, j]
    return out


def _log2_matrix(intensity_df: dict, run_columns: list[str]) -> np.ndarray:
    mat = _run_matrix(intensity_df, run_columns, np.float64).copy()
    mat[mat <= 0] = np.nan
    return np.log2(mat)


def direct_lfq(
    intensity_df: dict,
    group_keys,
    run_columns: list[str],
    normalize: bool = True,
    min_nonnan: int = 1,
    num_samples: int | None = None,
) -> dict:
    """Per-group LFQ intensity in every run: {group, run1, run2, ...}."""
    log_mat = _log2_matrix(intensity_df, run_columns)
    if normalize and log_mat.shape[1] > 1:
        log_mat = normalize_samples(log_mat, num_samples=num_samples)
    keys = np.asarray(group_keys)
    rows = []
    for key, idx in _groups_in_order(keys):
        est = estimate_group_intensity(log_mat[idx])
        if np.isfinite(est).sum() < min_nonnan:
            continue
        rows.append((key, np.power(2.0, est)))
    out = _lfq_frame(keys, rows, run_columns)
    logger.info(f"LFQ: quantified {len(rows)} groups over {len(run_columns)} runs")
    return out


def quantselect_ion_scores(feature_dfs: dict[str, dict], run_columns: list[str]) -> np.ndarray:
    """Per-ion quality weight in [0, 1], the mean of the terms present:
    mean XIC correlation; 1 / (1 + std of the mass error); the share of runs
    with signal; 1 / (1 + sd of the log2 intensities around the ion's
    median)."""
    n = n_rows(next(iter(feature_dfs.values())))
    terms = []
    if "correlation" in feature_dfs:
        corr = _run_matrix(feature_dfs["correlation"], run_columns, np.float64)
        terms.append(np.clip(np.nanmean(corr, axis=1), 0.0, 1.0))
    if "mass_error" in feature_dfs:
        me = _run_matrix(feature_dfs["mass_error"], run_columns, np.float64)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            me_std = np.nanstd(me, axis=1)
        me_std = np.where(np.isfinite(me_std), me_std, 5.0)
        terms.append(1.0 / (1.0 + me_std))
    if "intensity" in feature_dfs:
        inten = _run_matrix(feature_dfs["intensity"], run_columns, np.float64)
        with np.errstate(invalid="ignore"):
            present = (inten > 0) & np.isfinite(inten)
        terms.append(present.sum(axis=1) / max(len(run_columns), 1))
        log_i = np.where(present, np.log2(np.maximum(inten, 1e-12)), np.nan)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            dev = log_i - np.nanmedian(log_i, axis=1, keepdims=True)
            sd = np.nanstd(dev, axis=1)
        sd = np.where(np.isfinite(sd), sd, 2.0)
        terms.append(1.0 / (1.0 + sd))
    if not terms:
        return np.ones(n)
    return np.clip(np.mean(np.stack(terms, axis=0), axis=0), 1e-3, 1.0)


def _weighted_nanmedian(values: np.ndarray, weights: np.ndarray) -> float:
    ok = np.isfinite(values)
    if not ok.any():
        return np.nan
    v = values[ok]
    w = weights[ok]
    order = np.argsort(v)
    cw = np.cumsum(w[order])
    if cw[-1] <= 0:
        return float(np.median(v))
    idx = np.searchsorted(cw, 0.5 * cw[-1])
    return float(v[order][min(idx, len(v) - 1)])


def quantselect_lfq(feature_dfs: dict[str, dict], group_keys, run_columns: list[str], min_nonnan: int = 1) -> dict:
    """Feature-weighted group intensities: as ``direct_lfq``, the run
    profile and the level weighted medians of the aligned ions."""
    weights = quantselect_ion_scores(feature_dfs, run_columns)
    log_mat = _log2_matrix(feature_dfs["intensity"], run_columns)
    if log_mat.shape[1] > 1:
        log_mat = normalize_samples(log_mat)
    keys = np.asarray(group_keys)
    rows = []
    for key, idx in _groups_in_order(keys):
        sub = log_mat[idx]
        w = weights[idx]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            row_med = np.nanmedian(sub, axis=1, keepdims=True)
            centered = sub - row_med
            profile = np.array([_weighted_nanmedian(centered[:, j], w) for j in range(centered.shape[1])])
            level = _weighted_nanmedian(row_med[:, 0], w)
        est = profile + level
        if np.isfinite(est).sum() < min_nonnan:
            continue
        rows.append((key, np.power(2.0, est)))
    out = _lfq_frame(keys, rows, run_columns)
    logger.info(f"QuantSelect LFQ: quantified {len(rows)} groups over {len(run_columns)} runs")
    return out
