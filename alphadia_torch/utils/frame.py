"""Column-dict frames: the port's tables, one numpy array per column.

The JAX package passes pandas frames; the card machine has no pandas. These
helpers give the few frame operations the port needs, with pandas' results:
``concat`` fills a column that a part lacks with NaN, as ``pd.concat``.
"""

from __future__ import annotations

import numpy as np


class Frame(dict):
    """A column dict with pandas' ``attrs``: metadata that is no column."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.attrs: dict = {}


def n_rows(frame: dict) -> int:
    return len(next(iter(frame.values()))) if frame else 0


def take(frame: dict, idx) -> dict:
    """The rows ``idx`` (indices or a boolean mask) of every column; a
    ``Frame`` keeps its ``attrs``, as a pandas selection does."""
    rows = {k: v[idx] for k, v in frame.items()}
    if not isinstance(frame, Frame):
        return rows
    out = Frame(rows)
    out.attrs = dict(frame.attrs)
    return out


def concat(frames: list[dict]) -> dict:
    """Rows of ``frames`` one after another, columns in first-seen order."""
    names = list(dict.fromkeys(k for f in frames for k in f))
    out = {}
    for k in names:
        parts = [f[k] if k in f else np.full(n_rows(f), np.nan) for f in frames]
        out[k] = np.concatenate(parts)
    return out


def lexsort_rows(frame: dict, columns: list[str]) -> np.ndarray:
    """Row order of a stable ascending sort by ``columns`` (the first
    column most significant), as pandas' ``sort_values`` on several
    columns."""
    return np.lexsort([frame[c] for c in reversed(columns)])


def sort_rows_descending(frame: dict, columns: list[str]) -> np.ndarray:
    """Row order of pandas' ``sort_values(columns, ascending=False)``: each
    column's values descending, NaN last, rows that tie on every column in
    their original order."""
    keys = []
    for c in reversed(columns):
        v = np.asarray(frame[c])
        nan = np.isnan(v) if v.dtype.kind in "fc" else np.zeros(len(v), bool)
        uniq, code = np.unique(v[~nan], return_inverse=True)
        rank = np.full(len(v), len(uniq), np.int64)  # NaN after every value
        rank[~nan] = len(uniq) - 1 - code
        keys.append(rank)
    return np.lexsort(keys) if keys else np.arange(n_rows(frame))


def unique_in_order(values: np.ndarray) -> np.ndarray:
    """The distinct values in order of first appearance, as pandas'
    ``Series.unique`` (``np.unique`` sorts them)."""
    values = np.asarray(values)
    _, first = np.unique(values, return_index=True)
    return values[np.sort(first)]


def factorize(values) -> np.ndarray:
    """Codes of ``values`` numbered in order of first appearance, as
    ``pd.factorize(values, sort=False)[0]``."""
    uniq, first, inverse = np.unique(np.asarray(values), return_index=True, return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first)] = np.arange(len(uniq))
    return rank[inverse.reshape(-1)]


def rename(frame: dict, mapping: dict) -> dict:
    """The columns renamed in place of the old ones, as pandas' ``rename``."""
    return {mapping.get(k, k): v for k, v in frame.items()}


def copy_frame(frame: dict) -> dict:
    """A deep copy, as ``DataFrame.copy()``."""
    return {k: np.array(v, copy=True) for k, v in frame.items()}
