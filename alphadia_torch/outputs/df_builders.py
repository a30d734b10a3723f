"""The per-run rows of ``stat.tsv`` and ``internal.tsv``.

``stat``: per run and channel the precursor and protein-group counts, the
mean FWHMs, the optimized tolerances (``optimization.*``) and the
calibration accuracy and precision (``calibration.*``); a run whose PSMs
were all filtered away still gets its zero row, since a multistep plan
reads a row for every run. ``internal``: the phases' wall-clock durations.
"""

from __future__ import annotations

import numpy as np

from alphadia_torch.constants.keys import StatOutputCols
from alphadia_torch.utils.frame import n_rows


def nunique(values) -> int:
    """Distinct non-missing values, as pandas' ``nunique``."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        values = values[~np.isnan(values)]
    elif values.dtype.kind == "O":
        values = np.array([v for v in values if v is not None and not (isinstance(v, float) and np.isnan(v))], object)
    return len(set(values.tolist()))


def nanmean(values) -> float:
    """pandas' ``Series.mean()``: NaN skipped, a float32 column summed and
    divided in float32."""
    values = np.asarray(values)
    dtype = values.dtype if values.dtype.kind == "f" else np.float64
    ok = ~np.isnan(values) if values.dtype.kind == "f" else np.ones(len(values), bool)
    if not ok.any():
        return float("nan")
    return float(values[ok].sum(dtype=dtype) / dtype.type(ok.sum()))


def build_stat_df(
    run_name: str,
    run_psm_df: dict,
    optimization_state: dict | None = None,
    calibration_metrics: dict | None = None,
) -> dict:
    return rows_to_frame(build_stat_rows(run_name, run_psm_df, optimization_state, calibration_metrics))


def build_stat_rows(
    run_name: str,
    run_psm_df: dict,
    optimization_state: dict | None = None,
    calibration_metrics: dict | None = None,
) -> list[dict]:
    """``build_stat_df``'s rows (the table of several runs is made from all
    their rows at once, as ``pd.concat`` of their frames)."""
    rows = []
    has_channel = "channel" in run_psm_df
    channels = sorted(np.unique(run_psm_df["channel"]).tolist()) if has_channel else [0]
    if not channels:
        channels = [0]
    for channel in channels:
        sub = run_psm_df
        if has_channel:
            mask = np.asarray(run_psm_df["channel"]) == channel
            sub = {k: np.asarray(v)[mask] for k, v in run_psm_df.items()}
        row = {
            "run": run_name,
            "channel": channel,
            "precursors": n_rows(sub) if sub else 0,
            "proteins": nunique(sub["pg"]) if "pg" in sub else 0,
        }
        if "cycle_fwhm" in sub:
            row["fwhm_rt"] = nanmean(sub["cycle_fwhm"])
        if "mobility_fwhm" in sub:
            row["fwhm_mobility"] = nanmean(sub["mobility_fwhm"])
        if optimization_state:
            prefix = StatOutputCols.OPTIMIZATION_PREFIX
            for key in ("ms1_error", "ms2_error", "rt_error", "mobility_error"):
                if key in optimization_state:
                    row[f"{prefix}{key}"] = optimization_state[key]
        if calibration_metrics:
            for key, value in calibration_metrics.items():
                row[f"calibration.{key}"] = value
        rows.append(row)
    return rows


def build_internal_df(run_name: str, timings: dict) -> dict:
    return rows_to_frame([build_internal_row(run_name, timings)])


def build_internal_row(run_name: str, timings: dict) -> dict:
    row = {"run": run_name}
    for phase, rec in timings.items():
        row[f"duration_{phase}"] = rec.get("duration")
    return row


def collect_calibration_metrics(calibration_manager) -> dict:
    out = {}
    if calibration_manager is None:
        return out
    for group, ests in calibration_manager.groups.items():
        for name, est in ests.items():
            if est.metrics:
                prefix = (
                    "ms1" if (group, name) == ("precursor", "mz")
                    else "ms2" if (group, name) == ("fragment", "mz")
                    else f"{group}_{name}"
                )
                out[f"{prefix}_median_accuracy"] = est.metrics["median_accuracy"]
                out[f"{prefix}_median_precision"] = est.metrics["median_precision"]
    return out


def rows_to_frame(rows: list[dict]) -> dict:
    """A column dict from row dicts, columns in first-seen order, a missing
    value NaN (None for text), as ``pd.DataFrame(rows)`` and ``pd.concat``
    build it: a column of Python ints is int64, of numbers float64."""
    names = list(dict.fromkeys(k for r in rows for k in r))
    out = {}
    for name in names:
        vals = [r.get(name) for r in rows]
        present = [v for v in vals if v is not None]
        if present and all(isinstance(v, (bool, np.bool_)) for v in present) and len(present) == len(vals):
            out[name] = np.array(vals, bool)
        elif present and all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in present) and len(
            present
        ) == len(vals):
            out[name] = np.array(vals, np.int64)
        elif present and len(present) == len(vals) and all(isinstance(v, np.float32) for v in present):
            out[name] = np.array(vals, np.float32)
        elif all(isinstance(v, (int, float, np.integer, np.floating)) for v in present):
            out[name] = np.array([np.nan if v is None else float(v) for v in vals], np.float64)
        else:
            out[name] = np.array(vals, object)
    return out
