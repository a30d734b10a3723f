"""Inference with the peptide property models of a model directory.

    manager = FinetuneManager.load("weights/peptdeep_default")  # on the card
    rt_norm = manager.predict_rt(sequences, mods, mod_sites)

A model directory holds ``models.pkl``: ``{"variables": {"rt" | "ms2" |
"ccs" | "charge": flax variables as numpy arrays}, "metrics": ..., "meta":
...}``, the packaged weights or what the JAX package's transfer step saved
(``library_prediction.peptdeep_model_path``). It is read by an unpickler
that admits numpy's array, dtype and scalar reconstructors and nothing
else. Prediction runs in batches of ``PREDICT_BATCH`` precursors on the
manager's device. The transfer step's training half (``finetune_*``,
``save``) comes with the requant slice of the port.
"""

from __future__ import annotations

import importlib
import pickle
from pathlib import Path

import numpy as np
import torch

from alphadia_torch.convert import property_models_from_jax
from alphadia_torch.models.property_models import MODEL_OF, encode_sequences
from alphadia_torch.utils.device import resolve_device

_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy._core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "scalar"),
}


class _NumpyUnpickler(pickle.Unpickler):
    """Admits numpy's array, dtype and scalar and refuses every other global."""

    def find_class(self, module, name):
        if (module, name) not in _NUMPY_GLOBALS:
            raise pickle.UnpicklingError(f"models.pkl: {module}.{name} is not a numpy array, dtype or scalar")
        if module == "numpy":
            return getattr(np, name)
        try:  # numpy 2 writes numpy._core, numpy 1 numpy.core
            return getattr(importlib.import_module("numpy._core.multiarray"), name)
        except ImportError:
            return getattr(importlib.import_module("numpy.core.multiarray"), name)


def load_models_pickle(path: str | Path) -> dict:
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()


class FinetuneManager:
    # fixed batches keep the device's memory flat at proteome scale (millions
    # of precursors); the tail is padded to the batch as the JAX package pads
    # it to keep one compiled shape
    PREDICT_BATCH = 8192

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.variables: dict = {}
        self.models: dict = {}
        self.metrics: dict = {}

    @classmethod
    def load(cls, directory: str | Path, device=None) -> "FinetuneManager":
        obj = cls(device)
        state = load_models_pickle(Path(directory) / "models.pkl")
        obj.variables = state["variables"]
        for name, sd in property_models_from_jax(obj.variables).items():
            if name not in MODEL_OF:
                raise KeyError(f"models.pkl: unknown model {name!r}")
            model = MODEL_OF[name]()
            model.load_state_dict(sd)
            obj.models[name] = model.to(obj.device).eval()
        obj.metrics = state.get("metrics", {})
        return obj

    def _batched(self, fn, *arrays) -> np.ndarray:
        n = len(arrays[0])
        B = self.PREDICT_BATCH
        if n <= B:
            return self._run(fn, arrays)
        outs = []
        for s in range(0, n, B):
            e = min(s + B, n)
            chunk = [a[s:e] for a in arrays]
            if e - s < B:  # the tail padded to the batch with its last row
                pad = B - (e - s)
                chunk = [np.concatenate([c, np.repeat(c[-1:], pad, axis=0)]) for c in chunk]
            outs.append(self._run(fn, chunk)[: e - s])
        return np.concatenate(outs)

    def _run(self, fn, arrays) -> np.ndarray:
        with torch.inference_mode():
            return fn(*(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays)).cpu().numpy()

    def predict_rt(self, sequences, mods=None, mod_sites=None) -> np.ndarray:
        tokens, mod_mass = encode_sequences(sequences, mods, mod_sites)
        return self._batched(self.models["rt"], tokens, mod_mass)

    def predict_ms2(self, sequences, mods, mod_sites, charges, nce: float = 25.0) -> np.ndarray:
        tokens, mod_mass = encode_sequences(sequences, mods, mod_sites)
        model = self.models["ms2"]
        return self._batched(lambda t, m, c: model(t, m, c, nce), tokens, mod_mass, np.asarray(charges))

    def predict_charge(self, sequences, mods=None, mod_sites=None) -> np.ndarray:
        tokens, mod_mass = encode_sequences(sequences, mods, mod_sites)
        return self._batched(self.models["charge"], tokens, mod_mass)

    def predict_mobility(self, sequences, mods, mod_sites, charges) -> np.ndarray:
        tokens, mod_mass = encode_sequences(sequences, mods, mod_sites)
        return self._batched(self.models["ccs"], tokens, mod_mass, np.asarray(charges))
