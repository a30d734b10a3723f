"""Per-run spectral library initialisation: library RT mapped onto the
run's gradient, precursors restricted to the quadrupole's m/z range, an
optional channel filter."""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.library.speclib import SpecLibFlat
from alphadia_torch.utils.frame import copy_frame
from alphadia_torch.workflow.optimizers.optimization_lock import subset_flat_library

logger = logging.getLogger(__name__)


def norm_to_rt(dia_rt_values: np.ndarray, norm_values: np.ndarray) -> np.ndarray:
    """Map library RT values of any scale onto the run's gradient."""
    norm_values = np.asarray(norm_values, dtype=np.float64)
    lo, hi = norm_values.min(), norm_values.max()
    normed = np.zeros_like(norm_values) if hi - lo <= 0 else (norm_values - lo) / (hi - lo)
    return np.interp(normed, [0, 1], [dia_rt_values[0], dia_rt_values[-1]])


def init_spectral_library(
    dia_cycle: np.ndarray,
    dia_rt_values: np.ndarray,
    spectral_library: SpecLibFlat,
    channel_filter: str = "",
) -> SpecLibFlat:
    """A new SpecLibFlat of the observable precursors with run-normalised
    RT; the frames before the filter travel with it."""
    prec = copy_frame(spectral_library.precursor_df)
    prec["rt_library"] = norm_to_rt(dia_rt_values, prec["rt_library"]).astype(np.float32)

    lower = dia_cycle[dia_cycle > 0].min()
    upper = dia_cycle[dia_cycle > 0].max()
    n_before = int((prec["decoy"] == 0).sum())
    mask = (prec["mz_library"] >= lower) & (prec["mz_library"] <= upper)

    if channel_filter:
        channels = [int(c) for c in str(channel_filter).split(",")]
        mask &= np.isin(prec["channel"], channels)

    out = subset_flat_library(prec, spectral_library.fragment_df, mask)
    # the unfiltered frames travel together: precursor_df_unfiltered's
    # flat_frag_* indices point into the original fragment table
    out.precursor_df_unfiltered = prec
    out.fragment_df_unfiltered = spectral_library.fragment_df
    n_after = int((out.precursor_df["decoy"] == 0).sum())
    logger.log(25, "Library init: %s target precursors observable (%s removed)", f"{n_after:,}", f"{n_before - n_after:,}")
    return out
