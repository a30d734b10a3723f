"""Carry state across from the JAX package.

The extraction path has no trained weights: what carries across is the raw
file's state and the configs. These functions read attributes of the
objects they are given and import nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from alphadia_torch.rawdata.diadata import DiaData
from alphadia_torch.search.scoring import ScoringConfig
from alphadia_torch.search.selection import SelectionConfig

_DIA_FIELDS = (
    "cycle", "rt_values", "cycle_rt", "n_cycles", "n_slots", "has_ms1",
    "has_mobility", "mobility_values", "n_scan_bins", "peak_scanbin",
    "mobility_min", "mobility_max", "peak_mz", "peak_intensity", "cell_start",
    "n_bins", "bin_mz_min", "coarse_bin_width", "ghost_width", "peak_is_ghost",
    "_n_canonical", "mz_min", "mz_max", "quad_min_mz", "quad_max_mz",
)


def diadata_from_jax(dia) -> DiaData:
    """The port's DiaData holding copies of a JAX ``DiaData``'s host arrays."""
    kw = {}
    for name in _DIA_FIELDS:
        v = getattr(dia, name)
        kw[name] = np.array(v) if isinstance(v, np.ndarray) else v
    return DiaData(**kw)


def config_from_jax(cfg):
    """Map a JAX ``SelectionConfig`` or ``ScoringConfig`` onto the port's,
    keeping the fields the port has (device-transport options of the JAX
    drivers have no counterpart)."""
    target = SelectionConfig if hasattr(cfg, "coarsen_wide_windows") else ScoringConfig
    names = {f.name for f in dataclasses.fields(target)}
    return target(**{k: v for k, v in vars(cfg).items() if k in names})


def frame_from_pandas(df) -> dict:
    """Column dict of a pandas frame (read through ``columns``/``to_numpy``)."""
    return {str(c): df[c].to_numpy() for c in df.columns}

