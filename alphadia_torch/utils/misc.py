"""Small host-side helpers."""

from __future__ import annotations

import numpy as np


def candidate_hash(precursor_idx, rank) -> np.ndarray:
    """Pack (precursor_idx, rank) into an int64 candidate identity."""
    return np.asarray(precursor_idx, dtype=np.int64) + (np.asarray(rank, dtype=np.int64) << 32)
