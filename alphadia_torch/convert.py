"""Carry state across from the JAX package.

What carries across: the raw file's state, the configs, the FDR
classifier's weights (flax variables as numpy arrays, the format of the
packaged ``constants/classifier/*.pkl``) and the property models' weights
(the flax trees of ``constants/weights/peptdeep_default/models.pkl`` and of
a directory a transfer step saved). These functions read attributes of the
objects they are given and import nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
# (the Pallas switch, device-time instrumentation, the light download of the
# calibration loop): the port has no place for them
TRANSPORT_FIELDS = ("use_pallas", "bench_device_time", "transport_quant")


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



def classifier_from_jax(variables: dict) -> dict:
    """The state dict of the port's ``FeedForwardNN`` from flax variables:
    ``params/Dense_k/kernel`` [in, out] -> ``dense.k.weight`` [out, in],
    the biases, BatchNorm's scale and bias, and its running mean and var."""
    params, stats = variables["params"], variables["batch_stats"]["BatchNorm_0"]
    out = {
        "norm.scale": params["BatchNorm_0"]["scale"],
        "norm.bias": params["BatchNorm_0"]["bias"],
        "norm.mean": stats["mean"],
        "norm.var": stats["var"],
    }
    k = 0
    while f"Dense_{k}" in params:
        out[f"dense.{k}.weight"] = np.asarray(params[f"Dense_{k}"]["kernel"]).T
        out[f"dense.{k}.bias"] = params[f"Dense_{k}"]["bias"]
        k += 1
    return {name: torch.from_numpy(np.array(v, dtype=np.float32)) for name, v in out.items()}


def classifier_to_jax(state_dict: dict) -> dict:
    """Flax variables (numpy float32) from the port's ``FeedForwardNN``
    state dict: the inverse of :func:`classifier_from_jax`."""

    def a(name):
        return state_dict[name].detach().cpu().numpy().astype(np.float32)

    params = {"BatchNorm_0": {"scale": a("norm.scale"), "bias": a("norm.bias")}}
    k = 0
    while f"dense.{k}.weight" in state_dict:
        params[f"Dense_{k}"] = {"kernel": np.ascontiguousarray(a(f"dense.{k}.weight").T), "bias": a(f"dense.{k}.bias")}
        k += 1
    return {"params": params, "batch_stats": {"BatchNorm_0": {"mean": a("norm.mean"), "var": a("norm.var")}}}


# flax module path of a property model's parameter -> (the port's module,
# the layout change): Dense kernels are [in, out] against Linear's [out, in],
# Conv kernels [width, in, out] against Conv1d's [out, in, width]
_PROPERTY_LAYERS = {
    ("SequenceEncoder_0", "Embed_0"): ("encoder.embed", None),
    ("SequenceEncoder_0", "Dense_0"): ("encoder.mod", (1, 0)),
    ("SequenceEncoder_0", "Conv_0"): ("encoder.conv0", (2, 1, 0)),
    ("SequenceEncoder_0", "Conv_1"): ("encoder.conv1", (2, 1, 0)),
    ("Dense_0",): ("hidden", (1, 0)),
    ("Dense_1",): ("out", (1, 0)),
}
_PROPERTY_PARAMS = {"embedding": "weight", "kernel": "weight", "bias": "bias"}


def property_models_from_jax(variables: dict) -> dict:
    """The state dicts of the port's property models (``models/
    property_models.MODEL_OF``) from the flax variables of each, a dict like
    ``{"rt": {"params": {...}}, "ms2": ...}`` of numpy arrays. A layer or a
    parameter the mapping does not know raises."""
    out = {}
    for model, tree in variables.items():
        state = {}

        def visit(node, path):
            for key, value in node.items():
                if isinstance(value, dict):
                    visit(value, path + (key,))
                    continue
                layer = _PROPERTY_LAYERS.get(path)
                if layer is None or key not in _PROPERTY_PARAMS:
                    raise KeyError(f"{model}: no place in the port for the flax parameter {'/'.join(path + (key,))}")
                name, axes = layer
                a = np.asarray(value, dtype=np.float32)
                if axes is not None and key == "kernel":
                    a = a.transpose(axes)
                state[f"{name}.{_PROPERTY_PARAMS[key]}"] = torch.from_numpy(np.ascontiguousarray(a))

        visit(tree["params"], ())
        out[model] = state
    return out


def property_models_to_jax(state_dicts: dict) -> dict:
    """Flax variables (numpy float32) of each property model from the port's
    state dicts, ``{"rt": model.state_dict(), ...}``: the inverse of
    :func:`property_models_from_jax`, so that the JAX package's
    ``FinetuneManager.load`` reads what the port saves."""
    layer_of = {name: (path, axes) for path, (name, axes) in _PROPERTY_LAYERS.items()}
    param_of = {v: k for k, v in _PROPERTY_PARAMS.items()}
    out = {}
    for model, sd in state_dicts.items():
        params: dict = {}
        for key, value in sd.items():
            name, kind = key.rsplit(".", 1)
            path, axes = layer_of[name]
            a = value.detach().cpu().numpy().astype(np.float32)
            flax_name = "embedding" if path[-1].startswith("Embed") else param_of[kind]
            if axes is not None and kind == "weight":
                a = a.transpose(axes)
            node = params
            for part in path:
                node = node.setdefault(part, {})
            node[flax_name] = np.ascontiguousarray(a)
        out[model] = {"params": params}
    return out
