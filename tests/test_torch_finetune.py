"""The port's fine-tuning of the property models (``models/finetune.py``)
against the JAX package's, on the CPU, from seeded numpy inputs.

- the fresh init: each model's variables drawn without JAX equal flax's
  ``model.init(PRNGKey(k))`` within 4 float32 ulps (the bound the FDR
  classifier's init is held to: XLA's ``erfinv`` takes its own ``log1p``);
- one training step from the same variables and batch: the loss (rtol
  1e-5), the gradients (rtol 1e-4, atol 1e-6) and the parameters after
  ``torch.optim.Adam`` at ``max_lr * scale`` equal ``jax.value_and_grad``
  + ``optax.adam`` with the update scaled, rtol 1e-5; Adam's first step is
  ``lr * g / (|g| + eps)``, so the few weights (under 1%) whose gradient
  is float32 noise around zero (|g| <= 1e-6) are held within one step;
- each ``finetune_*`` against JAX's ``FinetuneManager`` (``force_scan =
  False``, the same config and ``random_state``, a fresh generator a model,
  3 epochs of 3 steps): the split's indices equal, ``history`` and
  ``test_history`` within rtol 1e-4, the metrics within rtol 1e-3 (one
  flipped charge label of ~1,400 moves the accuracy by 7e-4), the fitted
  models' predictions and parameters within atol 1e-3. The two fits part
  by float32 rounding (XLA's and oneDNN's convolution gradients sum in
  other orders), and training spreads it: Adam divides each step by the
  root of its second moment, so where a ReLU all but silences a
  convolution channel its gradients are rounding noise that moves those
  weights by a part of a step (max_lr 3e-3), and an L1 loss's gradient
  jumps where a prediction crosses its target. Measured on these inputs at
  random states 3-5: histories within 8.5e-5, metrics 1.9e-4 (the charge
  accuracy 8.4e-4 at 4 epochs: one label), predictions 2.4e-4; at 6 epochs
  of 5 steps the histories part by up to 1.3e-3;
- early stopping and plateau halving: a charge fit with ``lr_patience`` 1
  stops after 13 of 30 epochs in both packages with the same losses;
- the whole manager, four fits drawing from one generator, at epoch counts
  where nothing stops early;
- ``models.pkl`` both ways: JAX's ``FinetuneManager.load`` reads what the
  port saved and predicts within 1e-5 of the port, the port reads JAX's;
- ``SearchPlanOutput._build_transfer_model`` of both packages on one folder
  of JAX-written per-run files: the same ``stats.transfer.tsv`` columns,
  values within rtol 1e-4, the same model keys.
"""

import pickle
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from alphadia_torch.convert import frame_from_pandas, property_models_from_jax
from alphadia_torch.models import finetune as port_ft
from alphadia_torch.models.property_models import MODEL_OF, encode_sequences
from alphadia_torch.outputs.search_plan_output import SearchPlanOutput
from alphadia_torch.utils.tsv import read_tsv
from alphadia_tpu.models import finetune as jax_ft
from alphadia_tpu.models import property_models as jax_pm
from alphadia_tpu.outputs.search_plan_output import SearchPlanOutput as JaxSearchPlanOutput

pytest_plugins = ("torch_port_plugin",)

MODELS = ("rt", "charge", "ms2", "ccs")
FLAX_MODEL = {"rt": jax_pm.RTModel, "charge": jax_pm.ChargeModel, "ms2": jax_pm.MS2Model, "ccs": jax_pm.MobilityModel}
AAS = "ACDEFGHIKLMNPQRSTVWY"
HYDRO = dict(zip(AAS, np.linspace(-1.0, 2.0, len(AAS))))
CONFIG = {"epochs": 3, "batch_size": 112}


def world(n=240, seed=11, runs=("run_a", "run_b")):
    """Seeded PSMs of ``n`` peptides in two runs (pandas) and their
    fragments: RT from hydrophobicity, charges from the basic residues,
    mobility from length and charge, b/y intensities along the backbone;
    some oxidised methionines, some fragments outside the model's columns
    and some cells written twice."""
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list(AAS), rng.integers(7, 22))) for _ in range(n)]
    mods, sites = [], []
    for s in seqs:
        m = [i + 1 for i, a in enumerate(s) if a == "M" and rng.random() < 0.5]
        mods.append(";".join("Oxidation@M" for _ in m))
        sites.append(";".join(str(i) for i in m))
    rt = np.array([sum(HYDRO[a] for a in s) / len(s) for s in seqs])
    rt = (rt - rt.min()) / (rt.max() - rt.min())
    rows = []
    for r, run in enumerate(runs):
        for i, s in enumerate(seqs):
            z = 2 + min(sum(a in "KRH" for a in s), 2) - int(rng.random() < 0.15)
            rows.append({
                "run": run, "precursor_idx": i, "sequence": s, "mods": mods[i], "mod_sites": sites[i],
                "charge": z, "mod_seq_hash": np.uint64(zlib.crc32(f"{s}|{mods[i]}".encode()) * 7919 % 2**62),
                "rt_norm": np.float32(rt[i] + rng.normal(0, 0.02)),
                "mobility_observed": np.float32(0.6 + 0.02 * len(s) / z + rng.normal(0, 0.01)),
            })
    psm = pd.DataFrame(rows)
    frows = []
    for run, i, s, z in zip(psm["run"], psm["precursor_idx"], psm["sequence"], psm["charge"]):
        L = len(s)
        for pos in range(L - 1):
            for t, fz in ((98, 1), (121, 1), (121, 2), (121, 3)):
                inten = np.exp(-0.2 * abs(pos - L / 2)) * (2.0 if t == 121 else 1.0) / fz + rng.random() * 0.1
                frows.append({"run": run, "precursor_idx": i, "type": t, "charge": fz, "position": pos,
                              "intensity": np.float32(inten)})
        frows.append({"run": run, "precursor_idx": i, "type": 98, "charge": 1, "position": 0, "intensity": np.float32(3.0)})
    return psm, pd.DataFrame(frows)


@pytest.fixture(scope="module")
def data():
    return world()


def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


def flax_init(name):
    t, m = encode_sequences(["PEPTIDEK", "ACDMK"], ["", "Oxidation@M"], ["", "4"])
    args = (t, m) if name in ("rt", "charge") else (t, m, jnp.asarray(np.array([2, 3], np.int32)))
    return jax.tree_util.tree_map(np.asarray, FLAX_MODEL[name]().init(jax.random.PRNGKey(port_ft.INIT_KEY[name]), *args))


@pytest.mark.parametrize("name", MODELS)
def test_fresh_init_is_flax_init(name):
    want, got = flax_init(name), port_ft.init_variables(name)
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree_util.tree_leaves(got)):
        assert w.shape == g.shape and g.dtype == np.float32, path
        assert ulps(w, g) <= 4, (path, ulps(w, g))
        if path[-1].key == "bias":
            assert not g.any()


def _inputs(name, psm, frag):
    """A manager's training inputs and target for ``name`` (the port's
    encoding, equal to JAX's: tests/test_torch_prediction.py)."""
    mgr = port_ft.FinetuneManager(device="cpu")
    seen = {}
    mgr._fit = lambda n, inputs, target, loss: seen.update(inputs=inputs, target=target) or (
        np.zeros_like(target), {})
    p = frame_from_pandas(psm)
    {"rt": mgr.finetune_rt, "charge": mgr.finetune_charge, "ccs": mgr.finetune_ccs}.get(
        name, lambda d: mgr.finetune_ms2(d, frame_from_pandas(frag)))(p)
    return seen["inputs"], seen["target"]


JAX_LOSS = {
    "rt": lambda p, t: jnp.abs(p - t).mean(),
    "ccs": lambda p, t: jnp.abs(p - t).mean(),
    "ms2": lambda p, t: ((p - t) ** 2).mean(),
    "charge": lambda p, t: -(t * jnp.log(jnp.clip(p, 1e-6, 1 - 1e-6))
                             + (1 - t) * jnp.log(1 - jnp.clip(p, 1e-6, 1 - 1e-6))).mean(),
}
PORT_LOSS = {"rt": port_ft.l1_loss, "ccs": port_ft.l1_loss, "ms2": port_ft.mse_loss, "charge": port_ft.charge_loss}


@pytest.mark.parametrize("name", MODELS)
def test_one_training_step_is_optax_adam(name, data):
    inputs, target = _inputs(name, *data)
    idx = np.random.default_rng(5).permutation(len(target))[:48]
    batch, t = tuple(a[idx] for a in inputs), target[idx]
    variables, lr, scale = flax_init(name), 3e-3, 0.4

    model = FLAX_MODEL[name]()
    tx = optax.adam(lr)
    loss_j, grads = jax.value_and_grad(lambda q: JAX_LOSS[name](model.apply(q, *batch), t))(variables)
    updates, _ = tx.update(grads, tx.init(variables))
    want = optax.apply_updates(variables, jax.tree_util.tree_map(lambda u: u * scale, updates))

    ours = MODEL_OF[name]()
    ours.load_state_dict(property_models_from_jax({name: variables})[name])
    opt = torch.optim.Adam(ours.parameters(), lr=lr * scale, betas=(0.9, 0.999), eps=1e-8)
    loss_p = PORT_LOSS[name](ours(*(torch.from_numpy(a) for a in batch)), torch.from_numpy(t))
    loss_p.backward()
    opt.step()
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j), rtol=1e-5)
    got = port_ft.property_models_to_jax({name: ours.state_dict()})[name]
    got_grad = port_ft.property_models_to_jax({name: {k: p.grad for k, p in ours.named_parameters()}})[name]
    noise = 0
    for (path, w), g, gj, gp in zip(jax.tree_util.tree_flatten_with_path(want)[0], jax.tree_util.tree_leaves(got),
                                     jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(got_grad)):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gp, gj, rtol=1e-4, atol=1e-6, err_msg=str(path))
        # Adam's first step is lr * g / (|g| + eps): where the gradient is
        # float32 noise around zero (|g| <= 1e-6) the step follows the noise
        signal = np.abs(gj) > 1e-6
        noise += int((~signal).sum() - (gj == 0).sum())
        np.testing.assert_allclose(g[signal], np.asarray(w)[signal], rtol=1e-5, atol=1e-7, err_msg=str(path))
        np.testing.assert_allclose(g[~signal], np.asarray(w)[~signal], atol=lr * scale, err_msg=str(path))
    assert noise < 1e-2 * sum(np.size(x) for x in jax.tree_util.tree_leaves(want))


def _fit_both(name, psm, frag, config, random_state=3):
    """One ``finetune_<name>`` in each package from a fresh manager; the
    split each drew."""
    splits = {}
    jm = jax_ft.FinetuneManager(config, random_state=random_state)
    jm.trainer.force_scan = False
    pm = port_ft.FinetuneManager(config, random_state=random_state, device="cpu")
    for who, mgr in (("jax", jm), ("port", pm)):
        split = mgr.trainer.split
        mgr.trainer.split = lambda n, rng, who=who, split=split: splits.setdefault(who, []).append(split(n, rng)) or \
            splits[who][-1]
    args = {"jax": (psm, frag) if name == "ms2" else (psm,), "port": (frame_from_pandas(psm), frame_from_pandas(frag))
            if name == "ms2" else (frame_from_pandas(psm),)}
    out = {who: getattr(mgr, f"finetune_{name}")(*args[who]) for who, mgr in (("jax", jm), ("port", pm))}
    return jm, pm, out, splits


def _predict(mgr, name, psm):
    seqs, mods, sites = list(psm["sequence"]), list(psm["mods"]), list(psm["mod_sites"])
    z = psm["charge"].to_numpy()
    return np.asarray({
        "rt": lambda: mgr.predict_rt(seqs, mods, sites),
        "charge": lambda: mgr.predict_charge(seqs, mods, sites),
        "ms2": lambda: mgr.predict_ms2(seqs, mods, sites, z),
        "ccs": lambda: mgr.predict_mobility(seqs, mods, sites, z),
    }[name]())


def assert_same_fit(jm, pm, out, splits, names, psm):
    assert len(splits["jax"]) == len(splits["port"])
    for a, b in zip(splits["jax"], splits["port"]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for name in names:
        want, got = out[name]["jax"], out[name]["port"]
        assert list(want) == list(got)
        assert len(want["history"]) == len(got["history"])
        np.testing.assert_allclose(got["history"], want["history"], rtol=1e-4)
        np.testing.assert_allclose(np.array(got["test_history"]), np.array(want["test_history"]), rtol=1e-4)
        for k, v in want.items():
            if not isinstance(v, list):
                np.testing.assert_allclose(got[k], v, rtol=1e-3, err_msg=f"{name} {k}")
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jm.variables[name])[0],
                                jax.tree_util.tree_leaves(pm.variables[name])):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-3, err_msg=f"{name} {path}")
        np.testing.assert_allclose(_predict(pm, name, psm), _predict(jm, name, psm), atol=1e-3)


@pytest.mark.parametrize("name", MODELS)
def test_finetune_matches_jax(name, data):
    psm, frag = data
    jm, pm, out, splits = _fit_both(name, psm, frag, CONFIG)
    assert_same_fit(jm, pm, {name: out}, splits, [name], psm)


def test_plateau_halving_and_early_stop_match_jax(data):
    psm, frag = data
    config = {"epochs": 30, "batch_size": 112, "lr_patience": 1, "warmup_epochs": 1}
    jm, pm, out, splits = _fit_both("charge", psm, frag, config)
    assert len(out["jax"]["history"]) < config["epochs"]  # it stopped early
    assert_same_fit(jm, pm, {"charge": out}, splits, ["charge"], psm)


def test_the_manager_draws_one_generator_as_jax(data):
    """rt, charge, ms2 and ccs in turn from one generator: three epochs,
    under the warmup, so no fit stops early and moves the later splits."""
    psm, frag = data
    config = dict(CONFIG)
    jm = jax_ft.FinetuneManager(config, random_state=8)
    jm.trainer.force_scan = False
    pm = port_ft.FinetuneManager(config, random_state=8, device="cpu")
    splits, out = {}, {}
    for who, mgr in (("jax", jm), ("port", pm)):
        split = mgr.trainer.split
        mgr.trainer.split = lambda n, rng, who=who, split=split: splits.setdefault(who, []).append(split(n, rng)) or \
            splits[who][-1]
        p, f = (psm, frag) if who == "jax" else (frame_from_pandas(psm), frame_from_pandas(frag))
        for name in MODELS:
            args = (p, f) if name == "ms2" else (p,)
            out.setdefault(name, {})[who] = getattr(mgr, f"finetune_{name}")(*args)
    assert len(splits["port"]) == 4
    assert_same_fit(jm, pm, out, splits, MODELS, psm)


def test_models_pkl_reads_both_ways(tmp_path, data):
    psm, frag = data
    jm, pm, _, _ = _fit_both("ms2", psm, frag, {"epochs": 2, "batch_size": 64})
    pm.finetune_rt(frame_from_pandas(psm))
    pm.save(tmp_path / "port")
    jm.finetune_rt(psm)
    jm.save(tmp_path / "jax")
    with open(tmp_path / "port" / "models.pkl", "rb") as f:
        saved = pickle.load(f)
    assert sorted(saved["variables"]) == ["ms2", "rt"] and saved["meta"] == {"nce": 25, "instrument": "Lumos"}
    assert saved["metrics"]["rt"]["r2"] == pm.metrics["rt"]["r2"]
    jax_reads_port = jax_ft.FinetuneManager.load(tmp_path / "port")
    port_reads_jax = port_ft.FinetuneManager.load(tmp_path / "jax", device="cpu")
    for name in ("rt", "ms2"):
        np.testing.assert_allclose(_predict(jax_reads_port, name, psm), _predict(pm, name, psm), atol=1e-5)
        np.testing.assert_allclose(_predict(port_reads_jax, name, psm), _predict(jm, name, psm), atol=1e-5)


def write_jax_runs(root, psm, frag):
    """Per-run ``psm.parquet`` / ``frag.parquet`` as the JAX package's step
    writes them, with the columns the transfer library reads."""
    rng = np.random.default_rng(2)
    folders = []
    for run, p in psm.groupby("run", sort=True):
        d = root / run
        d.mkdir(parents=True)
        p = p.assign(
            mod_seq_charge_hash=p["mod_seq_hash"] + p["charge"].astype(np.uint64),
            decoy=0, proba=rng.uniform(0, 0.05, len(p)),
            rt_observed=(p["rt_norm"] * 1000 + rng.normal(0, 5, len(p))).astype(np.float32),
        ).drop(columns=["run", "rt_norm"])
        f = frag[frag["run"] == run].drop(columns="run").assign(correlation=lambda x: rng.uniform(0.6, 1.0, len(x)))
        p.to_parquet(d / "psm.parquet", index=False)
        f.to_parquet(d / "frag.parquet", index=False)
        folders.append(d)
    return folders


def test_build_transfer_model_matches_jax(tmp_path, data):
    folders = write_jax_runs(tmp_path / "quant", *data)
    config = {
        "transfer_library": {"enabled": True, "top_k_samples": 3, "precursor_correlation_cutoff": 0.5,
                             "fragment_correlation_ratio": 0.75, "norm_delta_max": True},
        "transfer_learning": {"enabled": True, "epochs": 3, "batch_size": 64},
    }
    stats = {}
    for who, cls, kw in (("jax", JaxSearchPlanOutput, {}), ("port", SearchPlanOutput, {"device": "cpu"})):
        out = tmp_path / who
        out.mkdir()
        spo = cls(config, out, **kw)
        spo._build_transfer_model(*spo._build_transfer_library(folders))
        stats[who] = read_tsv(out / "stats.transfer.tsv")
        with open(out / "peptdeep.transfer" / "models.pkl", "rb") as f:
            stats[who + "_models"] = sorted(pickle.load(f)["variables"])
    assert list(stats["port"]) == list(stats["jax"])
    assert "rt_r2" in stats["port"] and "ms2_spectral_angle" in stats["port"] and "charge_accuracy" in stats["port"]
    for k in stats["jax"]:
        np.testing.assert_allclose(stats["port"][k], stats["jax"][k], rtol=1e-4, err_msg=k)
    assert stats["port_models"] == stats["jax_models"] == ["ccs", "charge", "ms2", "rt"]
