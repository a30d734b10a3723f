"""Target-decoy q-values on column-dict frames.

Sort by (score, decoy, tie-break columns) ascending, FDR = cumulative
decoys / cumulative targets, q-value = the reverse running minimum. The
sorts keep pandas' semantics: a stable sort over several columns, the
first column most significant.
"""

from __future__ import annotations

import numpy as np

from alphadia_torch.utils.frame import lexsort_rows, take


def fdr_to_q_values(fdr_values: np.ndarray) -> np.ndarray:
    """Reverse running minimum of an FDR array sorted by ascending score."""
    return np.flip(np.minimum.accumulate(np.flip(fdr_values)))


def get_q_values(
    df: dict,
    score_column: str = "proba",
    decoy_column: str = "_decoy",
    qval_column: str = "qval",
    extra_sort_columns: list[str] | None = None,
) -> dict:
    """The rows sorted by score (lower is better: the probability of being
    a decoy), with q-values added."""
    if extra_sort_columns is None:
        extra_sort_columns = ["precursor_idx"]
    extra = [c for c in extra_sort_columns if c in df]
    df = take(df, lexsort_rows(df, [score_column, decoy_column, *extra]))
    decoys = df[decoy_column].astype(np.float64)
    decoy_cumsum = np.cumsum(decoys)
    target_cumsum = np.cumsum(1.0 - decoys)
    with np.errstate(divide="ignore", invalid="ignore"):
        fdr_values = decoy_cumsum / np.maximum(target_cumsum, 1.0)
    df[qval_column] = fdr_to_q_values(fdr_values)
    return df


def keep_best(df: dict, score_column: str = "proba", group_columns: list[str] | None = None) -> dict:
    """The best (lowest score) row of each group, in the rows' own order.
    Rows whose group key holds a NaN belong to no group and go, as in
    pandas' ``groupby(...).head(1)``."""
    if group_columns is None:
        group_columns = ["channel", "precursor_idx"]
    group_columns = [c for c in group_columns if c in df]
    if not group_columns:
        raise ValueError("No group keys passed!")
    order = lexsort_rows(df, [score_column, *group_columns])
    key = np.zeros(len(order), np.int64)
    grouped = np.ones(len(order), bool)
    for c in group_columns:
        col = df[c]
        if col.dtype.kind == "f":
            grouped &= ~np.isnan(col)
        _, codes = np.unique(col, return_inverse=True)
        key = key * (int(codes.max(initial=0)) + 1) + codes.reshape(-1)
    order = order[grouped[order]]
    _, first = np.unique(key[order], return_index=True)
    return take(df, np.sort(order[first]))
