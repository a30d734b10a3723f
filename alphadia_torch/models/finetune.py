"""Transfer learning: fine-tune the peptide property models on a search's
transfer library, save them, and predict with them.

    manager = FinetuneManager(config["transfer_learning"], random_state=0)  # on the card
    manager.finetune_rt(psm)            # psm: sequence, mods, mod_sites, rt_norm
    manager.finetune_charge(psm)        # + charge, mod_seq_hash
    manager.finetune_ms2(psm, frag)     # frag: type, charge, position, intensity
    manager.finetune_ccs(psm)           # + mobility_observed; skipped without mobility
    manager.save(out / "peptdeep.transfer")
    FinetuneManager.load("weights/peptdeep_default").predict_rt(sequences, mods, mod_sites)

The JAX package's ``models/finetune.py``, fit for fit:

- ``_Trainer.fit``: a train / validation / test split from one permutation
  of the numpy generator; batches of ``min(batch_size, n_train)``, the
  ``n_train // bs`` full ones an epoch in the order of a fresh permutation
  (the remainder dropped); Adam (optax's defaults) at ``max_lr * 30``,
  whose update the schedule scales: a linear warmup over
  ``warmup_epochs``, then halving after ``lr_patience`` epochs without a
  better validation loss, stopping once the scale falls below 1e-2; the
  best validation loss's parameters are kept (a copy); the test loss every
  ``test_interval`` epochs. ``torch.optim.Adam`` computes optax's Adam; the
  schedule sets the group's ``lr`` to ``max_lr * scale`` each epoch (a
  scaled gradient would cancel in ``m / sqrt(v)``);
- one numpy generator for the manager (``random_state``), drawn by the
  fits in the order they run;
- a fresh model starts from flax's ``model.init(PRNGKey(k))`` with k = 0, 1,
  2, 3 for rt, charge, ms2 and ccs, drawn without JAX
  (``utils/jax_random``): ``lecun_normal`` kernels, the embedding's
  ``default_embed_init``, zero biases; a loaded manager fine-tunes its
  models;
- the losses: L1 (RT, mobility), binary cross-entropy on the charge
  probabilities clipped to [1e-6, 1 - 1e-6] with ``jnp.clip``'s half
  gradient at a bound (``torch.minimum``/``maximum``), squared error on the
  MS2 intensities;
- training runs on the manager's device; the training inputs, the
  validation split and the test split are uploaded once each, an epoch's
  batch indices once an epoch.

``models.pkl`` holds ``{"variables": flax trees of numpy arrays (the
JAX package's layout, ``convert.property_models_to_jax``), "metrics":
..., "meta": {"nce", "instrument"}}``, the packaged weights or what either
package's transfer step saved (``library_prediction.peptdeep_model_path``).
It is read by an unpickler that admits numpy's array, dtype and scalar
reconstructors and nothing else. Prediction runs in batches of
``PREDICT_BATCH`` precursors on the manager's device.
"""

from __future__ import annotations

import importlib
import logging
import pickle
from pathlib import Path

import numpy as np
import torch

from alphadia_torch.convert import property_models_from_jax, property_models_to_jax
from alphadia_torch.library.speclib import str_col
from alphadia_torch.models.property_models import FRAG_COLS, MAX_CHARGE, MAX_LEN, MODEL_OF, encode_sequences
from alphadia_torch.reporting import PROGRESS
from alphadia_torch.utils.device import resolve_device
from alphadia_torch.utils.frame import n_rows
from alphadia_torch.utils.jax_random import embed_normal, flax_rng, lecun_normal, prng_key

logger = logging.getLogger(__name__)

MODEL_DIR_NAME = "peptdeep.transfer"

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


def _spectral_angle(a, b, axis=-1, eps=1e-9):
    na = np.linalg.norm(a, axis=axis)
    nb = np.linalg.norm(b, axis=axis)
    cos = (a * b).sum(axis=axis) / np.maximum(na * nb, eps)
    cos = np.clip(cos, -1, 1)
    return 1 - 2 * np.arccos(cos) / np.pi


def _r2(y_true, y_pred):
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean()) ** 2)
    return 1 - ss_res / max(ss_tot, 1e-12)


# each model's flax init key and the widths of its head (input, output)
INIT_KEY = {"rt": 0, "charge": 1, "ms2": 2, "ccs": 3}
_HEAD = {"rt": (65, 1), "charge": (65, MAX_CHARGE), "ms2": (130, len(FRAG_COLS)), "ccs": (66, 1)}


def init_variables(name: str, dim: int = 64, vocab: int = 22, kernel: int = 5) -> dict:
    """flax's ``model.init(PRNGKey(INIT_KEY[name]), ...)`` of a property
    model: its variables as numpy arrays, drawn without JAX."""
    key = prng_key(INIT_KEY[name])

    def dense(path, shape, init=lecun_normal):
        return {"kernel": init(flax_rng(key, *path, 1), shape), "bias": np.zeros(shape[-1], np.float32)}

    enc = ("SequenceEncoder_0",)
    n_in, n_out = _HEAD[name]
    params = {
        "SequenceEncoder_0": {
            "Embed_0": {"embedding": embed_normal(flax_rng(key, *enc, "Embed_0", 1), (vocab, dim))},
            "Dense_0": dense(enc + ("Dense_0",), (1, dim)),
            "Conv_0": dense(enc + ("Conv_0",), (kernel, dim, dim)),
            "Conv_1": dense(enc + ("Conv_1",), (kernel, dim, dim)),
        },
        "Dense_0": dense(("Dense_0",), (n_in, dim)),
        "Dense_1": dense(("Dense_1",), (dim, n_out)),
    }
    return {"params": params}


def l1_loss(pred, target):
    return (pred - target).abs().mean()


def mse_loss(pred, target):
    return ((pred - target) ** 2).mean()


def charge_loss(pred, target):
    # jnp.clip is maximum then minimum: half the gradient at a bound
    p = torch.minimum(torch.maximum(pred, pred.new_tensor(1e-6)), pred.new_tensor(1 - 1e-6))
    return -(target * torch.log(p) + (1 - target) * torch.log(1 - p)).mean()


class _Trainer:
    """Shared training loop: warmup + plateau LR, early stopping."""

    def __init__(self, config: dict | None = None):
        cfg = config or {}
        self.batch_size = cfg.get("batch_size", 2000)
        self.max_lr = cfg.get("max_lr", 1e-4) * 30  # small models train faster
        self.epochs = cfg.get("epochs", 51)
        self.warmup_epochs = cfg.get("warmup_epochs", 5)
        self.lr_patience = cfg.get("lr_patience", 6)
        self.train_fraction = cfg.get("train_fraction", 0.7)
        self.validation_fraction = cfg.get("validation_fraction", 0.2)
        self.test_fraction = cfg.get("test_fraction", 0.1)
        self.test_interval = max(int(cfg.get("test_interval", 1)), 1)
        self.nce = cfg.get("nce", 25)
        self.instrument = cfg.get("instrument", "Lumos")
        total = self.train_fraction + self.validation_fraction + self.test_fraction
        if abs(total - 1.0) > 1e-6:
            logger.warning(
                f"transfer_learning split fractions sum to {total:.3f}; "
                "the test split absorbs the remainder after train+val"
            )
        # per fit: epochs run and optimizer steps taken
        self.last_fit: dict = {}

    def split(self, n, rng):
        perm = rng.permutation(n)
        n_train = int(n * self.train_fraction)
        n_val = int(n * self.validation_fraction)
        return perm[:n_train], perm[n_train : n_train + n_val], perm[n_train + n_val :]

    def fit(self, model, inputs: tuple, target, loss_fn, rng, device):
        """Mini-batch training of ``model`` (on ``device``) in place; returns
        the info dict. ``inputs``: numpy arrays sharing axis 0."""
        n = len(target)
        train_idx, val_idx, test_idx = self.split(n, rng)
        self.last_fit = {"epochs": 0, "steps": 0}
        if len(train_idx) < 2:
            return {}
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        dev_in = tuple(up(a) for a in inputs)
        dev_t = up(target)
        # held-out splits upload once, not once per epoch
        vin = tuple(up(a[val_idx]) for a in inputs) if len(val_idx) else None
        vt = up(target[val_idx]) if len(val_idx) else None
        tin = tuple(up(a[test_idx]) for a in inputs) if len(test_idx) else None
        tt = up(target[test_idx]) if len(test_idx) else None

        def eval_loss(ins, tgt):
            with torch.no_grad():
                return float(loss_fn(model(*ins), tgt))

        opt = torch.optim.Adam(model.parameters(), lr=self.max_lr, betas=(0.9, 0.999), eps=1e-8)
        bs = min(self.batch_size, len(train_idx))
        nb = max(len(train_idx) // bs, 1)
        best_val = np.inf
        best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        plateau = 0
        lr_scale = 1.0
        history = []
        test_history = []
        for epoch in range(self.epochs):
            scale = lr_scale * (epoch + 1) / self.warmup_epochs if epoch < self.warmup_epochs else lr_scale
            for group in opt.param_groups:
                group["lr"] = self.max_lr * scale
            order = rng.permutation(len(train_idx))
            idx_mat = up(train_idx[order[: nb * bs]].astype(np.int64).reshape(nb, bs))
            for b in range(nb):
                idx = idx_mat[b]
                loss = loss_fn(model(*(a.index_select(0, idx) for a in dev_in)), dev_t.index_select(0, idx))
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
            self.last_fit = {"epochs": epoch + 1, "steps": (epoch + 1) * nb}
            vloss = eval_loss(vin, vt) if vin is not None else 0.0
            history.append(vloss)
            if tin is not None and epoch % self.test_interval == 0:
                test_history.append((epoch, eval_loss(tin, tt)))
            if vloss < best_val - 1e-6:
                best_val = vloss
                best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
                plateau = 0
            else:
                plateau += 1
                if plateau >= self.lr_patience:
                    lr_scale *= 0.5
                    plateau = 0
                if lr_scale < 1e-2:
                    break
        model.load_state_dict(best_state)
        info = {"val_loss": best_val, "history": history}
        if test_history:
            info["test_history"] = test_history
        if tin is not None:
            info["test_loss"] = eval_loss(tin, tt)
        return info


class FinetuneManager:
    # fixed batches keep the device's memory flat at proteome scale (millions
    # of precursors); the tail is padded to the batch as the JAX package pads
    # it to keep one compiled shape
    PREDICT_BATCH = 8192

    def __init__(self, config: dict | None = None, random_state: int = 0, device=None):
        self.device = resolve_device(device)
        self.trainer = _Trainer(config)
        self.rng = np.random.default_rng(random_state)
        self.variables: dict = {}
        self.models: dict = {}
        self.metrics: dict[str, dict] = {}

    @classmethod
    def load(cls, directory: str | Path, device=None) -> "FinetuneManager":
        obj = cls(device=device)
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

    def save(self, directory: str | Path) -> None:
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        with open(directory / "models.pkl", "wb") as f:
            pickle.dump(
                {
                    "variables": self.variables,
                    "metrics": self.metrics,
                    # acquisition context the models were tuned on
                    # (transfer_learning.nce / .instrument)
                    "meta": {"nce": self.trainer.nce, "instrument": self.trainer.instrument},
                },
                f,
            )

    # ------------------------------------------------------------------
    def _model(self, name: str):
        """The model to fine-tune: the loaded one, or flax's fresh init."""
        if name not in self.models:
            model = MODEL_OF[name]()
            model.load_state_dict(property_models_from_jax({name: init_variables(name)})[name])
            self.models[name] = model.to(self.device)
        return self.models[name].train()

    def _fit(self, name: str, inputs: tuple, target, loss_fn) -> tuple:
        model = self._model(name)
        info = self.trainer.fit(model, inputs, target, loss_fn, self.rng, self.device)
        model.eval()
        self.variables[name] = property_models_to_jax({name: model.state_dict()})[name]
        with torch.no_grad():
            pred = model(*(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in inputs)).cpu().numpy()
        return pred, info

    def finetune_rt(self, psm_df: dict) -> dict:
        """psm_df needs sequence/mods/mod_sites + rt_norm (0..1 observed)."""
        tokens, mod_mass = encode_sequences(list(psm_df["sequence"]), list(str_col(psm_df, "mods")),
                                            list(str_col(psm_df, "mod_sites")))
        target = np.asarray(psm_df["rt_norm"], np.float32)
        pred, info = self._fit("rt", (tokens, mod_mass), target, l1_loss)
        err = np.abs(pred - target)
        self.metrics["rt"] = {"r2": _r2(target, pred), "abs_error_95": float(np.percentile(err, 95)),
                              "l1": float(err.mean()), **info}
        logger.log(PROGRESS, f"finetune rt: R2={self.metrics['rt']['r2']:.3f}")
        return self.metrics["rt"]

    def finetune_charge(self, psm_df: dict) -> dict:
        """Multi-label observed charges per modified sequence, the groups in
        the order of their ``mod_seq_hash`` (pandas' ``groupby``)."""
        keys, first, inverse = np.unique(np.asarray(psm_df["mod_seq_hash"]), return_index=True, return_inverse=True)
        pick = lambda col: [col[i] for i in first]  # noqa: E731
        tokens, mod_mass = encode_sequences(pick(list(psm_df["sequence"])), pick(list(str_col(psm_df, "mods"))),
                                            pick(list(str_col(psm_df, "mod_sites"))))
        target = np.zeros((len(keys), MAX_CHARGE), np.float32)
        z = np.asarray(psm_df["charge"]).astype(np.int64)
        ok = (z >= 1) & (z <= MAX_CHARGE)
        target[inverse.reshape(-1)[ok], z[ok] - 1] = 1.0
        pred, info = self._fit("charge", (tokens, mod_mass), target, charge_loss)
        acc = float(((pred > 0.5) == (target > 0.5)).mean())
        self.metrics["charge"] = {"accuracy": acc, **info}
        logger.log(PROGRESS, f"finetune charge: accuracy={acc:.3f}")
        return self.metrics["charge"]

    def finetune_ms2(self, psm_df: dict, frag_df: dict) -> dict:
        """frag_df: per-PSM fragments (type/charge/position/intensity). A
        fragment goes to the PSM of its (run, precursor_idx) where both
        frames have ``run`` (the transfer table holds up to
        ``top_k_samples`` rows a precursor, one a run), else of its
        precursor_idx; the last PSM row of a key takes it, and the last
        fragment row of a cell wins."""
        n = n_rows(psm_df)
        tokens, mod_mass = encode_sequences(list(psm_df["sequence"]), list(str_col(psm_df, "mods")),
                                            list(str_col(psm_df, "mod_sites")))
        charge = np.asarray(psm_df["charge"]).astype(np.int32)
        pidx = np.asarray(psm_df["precursor_idx"]).astype(np.int64)
        fp = np.asarray(frag_df["precursor_idx"]).astype(np.int64)
        if "run" in psm_df and "run" in frag_df:
            row_of = {(r, p): i for i, (r, p) in enumerate(zip(np.asarray(psm_df["run"]).tolist(), pidx.tolist()))}
            keys = zip(np.asarray(frag_df["run"]).tolist(), fp.tolist())
        else:
            row_of = {p: i for i, p in enumerate(pidx.tolist())}
            keys = fp.tolist()
        row = np.array([row_of.get(k, -1) for k in keys], np.int64)
        col_of = {c: j for j, c in enumerate(FRAG_COLS)}
        types = np.asarray(frag_df["type"]).astype(np.int64)
        zs = np.asarray(frag_df["charge"]).astype(np.int64)
        col = np.array([col_of.get(f"{chr(t)}_z{z}", -1) for t, z in zip(types.tolist(), zs.tolist())], np.int64)
        pos = np.asarray(frag_df["position"]).astype(np.int64)
        keep = (row >= 0) & (col >= 0) & (pos >= 0) & (pos < MAX_LEN - 1)
        target = np.zeros((n, MAX_LEN - 1, len(FRAG_COLS)), np.float32)
        cell = ((row * (MAX_LEN - 1) + pos) * len(FRAG_COLS) + col)[keep]
        inten = np.asarray(frag_df["intensity"])[keep]
        # the last row of a cell wins, as the reference's assignment loop
        last = len(cell) - 1 - np.unique(cell[::-1], return_index=True)[1]
        target.reshape(-1)[cell[last]] = inten[last]
        peak = target.max(axis=(1, 2), keepdims=True)
        target = target / np.maximum(peak, 1e-9)
        pred, info = self._fit("ms2", (tokens, mod_mass, charge), target, mse_loss)
        sa = _spectral_angle(pred.reshape(n, -1), target.reshape(n, -1))
        self.metrics["ms2"] = {"spectral_angle": float(np.nanmean(sa)), **info}
        logger.log(PROGRESS, f"finetune ms2: SA={self.metrics['ms2']['spectral_angle']:.3f}")
        return self.metrics["ms2"]

    def finetune_ccs(self, psm_df: dict) -> dict:
        if "mobility_observed" not in psm_df or (np.abs(np.asarray(psm_df["mobility_observed"])) < 1e-3).all():
            logger.info("no mobility dimension; skipping ccs finetune")
            return {}
        tokens, mod_mass = encode_sequences(list(psm_df["sequence"]), list(str_col(psm_df, "mods")),
                                            list(str_col(psm_df, "mod_sites")))
        charge = np.asarray(psm_df["charge"]).astype(np.int32)
        target = np.asarray(psm_df["mobility_observed"], np.float32)
        pred, info = self._fit("ccs", (tokens, mod_mass, charge), target, l1_loss)
        self.metrics["ccs"] = {"r2": _r2(target, pred), **info}
        return self.metrics["ccs"]

    # ------------------------------------------------------------------
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
