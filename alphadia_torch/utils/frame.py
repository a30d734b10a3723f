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
    """The rows ``idx`` (indices or a boolean mask) of every column."""
    return {k: v[idx] for k, v in frame.items()}


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
