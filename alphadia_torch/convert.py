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


# fields of the JAX configs that only steer how the JAX drivers move data
# (the Pallas switch, the device mesh, device-time instrumentation, the
# light download of the calibration loop): the port has no place for them
TRANSPORT_FIELDS = ("use_pallas", "mesh_devices", "bench_device_time", "transport_quant")


def config_from_jax(cfg):
    """Map a JAX ``SelectionConfig`` or ``ScoringConfig`` onto the port's.
    Only the transport fields above may be dropped: any other field the
    port's config lacks raises, so that no setting vanishes silently."""
    target = SelectionConfig if hasattr(cfg, "coarsen_wide_windows") else ScoringConfig
    names = {f.name for f in dataclasses.fields(target)}
    values = vars(cfg)
    lost = sorted(k for k in values if k not in names and k not in TRANSPORT_FIELDS)
    if lost:
        raise ValueError(f"{type(cfg).__name__} fields with no place in the port's {target.__name__}: {lost}")
    return target(**{k: v for k, v in values.items() if k in names})


def frame_from_pandas(df) -> dict:
    """Column dict of a pandas frame (read through ``columns``/``to_numpy``)."""
    return {str(c): df[c].to_numpy() for c in df.columns}

