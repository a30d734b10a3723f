"""The port's property-model trainer
(``alphadia_torch/scripts/train_property_models.py``) against the JAX
package's ``scripts/train_property_models.py``, loaded by path. Only the
JAX script's helpers are called: its ``main``, ``revalidate`` and
``retrain_charge`` write into the JAX package's ``constants/``.

- the sequence draws are JAX's exactly, the frames JAX's (one process, so
  ``hash`` agrees);
- on the packaged weights (byte-equal in both packages) the evaluation
  and every published-constants gate give JAX's values at atol 1e-5;
- ``main`` at a tiny size (150 sequences a world, 2 epochs, the CPU) is refused below
  the packaging bars and writes nothing; past the bars (patched here) it
  writes ``models.pkl``, which JAX's ``FinetuneManager.load`` reads and
  which predicts there what the port predicts (1e-5); ``--revalidate``
  writes the packaged weights with JAX's gate readings.

Run as a script it prints the readings that ``chip_smoke.py`` phase [17c]
gates against: JAX's helpers at [17c]'s cut on the CPU (``--jax``), or the
port's trainer at that cut (``--device cpu|cuda``); ``--full`` at the
packaged run's size:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_property_models.py --jax [--full]
"""

import argparse
import functools
import importlib.util
import json
import pickle
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from alphadia_torch.convert import frame_from_pandas
from alphadia_torch.models.finetune import FinetuneManager
from alphadia_torch.scripts import train_property_models as port
from alphadia_torch.testing.physics import PeptidePhysics

pytest_plugins = ("torch_port_plugin",)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(sequences_per_world=150, ms2_subset=300, eval_sequences=100, epochs=2)
# phase [17c]'s cut of the packaged run (chip_smoke.PM_CUT)
CUT = dict(sequences_per_world=4000, ms2_subset=7000, eval_sequences=1000, epochs=20)
FULL = dict(sequences_per_world=port.SEQUENCES_PER_WORLD, ms2_subset=port.MS2_SUBSET,
            eval_sequences=port.EVAL_SEQUENCES, epochs=port.CONFIG["epochs"])


def jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_property_models",
                                                  REPO / "scripts" / "train_property_models.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax():
    return jax_script()


@pytest.fixture(scope="module")
def packaged(jax):
    """The packaged models in each package (byte-equal files)."""
    from alphadia_tpu.models.finetune import FinetuneManager as JaxFinetuneManager

    ours = REPO / "alphadia_torch" / "constants" / "weights" / "peptdeep_default"
    theirs = REPO / "alphadia_tpu" / "constants" / "weights" / "peptdeep_default"
    assert (ours / "models.pkl").read_bytes() == (theirs / "models.pkl").read_bytes()
    return FinetuneManager.load(ours, device="cpu"), JaxFinetuneManager.load(theirs)


def assert_close(a, b, path=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in b:
            assert_close(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (bool, np.bool_, str)) or b is None:
        assert a == b, path
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=path)


def assert_frame_equal(ours: dict, theirs: pd.DataFrame):
    assert list(ours) == list(theirs.columns)
    for c, want in frame_from_pandas(theirs).items():
        got = ours[c]
        if want.dtype == object:
            assert [str(x) for x in got] == [str(x) for x in want], c
        else:
            assert got.dtype == want.dtype, (c, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=c)


def test_sequence_draws_are_jax_draws(jax):
    for seed in (11, 99, 101):
        assert port._tryptic_sequences(np.random.default_rng(seed), 400) == jax._tryptic_sequences(
            np.random.default_rng(seed), 400)
    assert port._trypsin_faithful_sequences(np.random.default_rng(773), 300) == jax._trypsin_faithful_sequences(
        np.random.default_rng(773), 300)
    # the worlds' corpus and the held-out draws, as JAX's main makes them
    per_world, seen, _ = port._training_sequences(300)
    rng, theirs, seen_j = np.random.default_rng(11), [], set()
    for _ in jax.TRAIN_WORLD_SEEDS:
        seqs = [s for s in dict.fromkeys(jax._tryptic_sequences(rng, 300)) if s not in seen_j]
        seen_j.update(seqs)
        theirs.append(seqs)
    assert per_world == theirs and seen == seen_j
    assert port._unseen(101, 200, seen) == [
        s for s in dict.fromkeys(jax._tryptic_sequences(np.random.default_rng(101), 200)) if s not in seen_j]


@pytest.mark.parametrize("with_frags", [True, False], ids=["frags", "no_frags"])
def test_frames_are_jax_frames(jax, with_frags):
    from alphadia_tpu.testing.physics import PeptidePhysics as JaxPhysics

    per_world, _, _ = port._training_sequences(120)
    ours = port._multi_world_frame(per_world, [PeptidePhysics(seed=s) for s in port.TRAIN_WORLD_SEEDS], None,
                                   with_frags=with_frags)
    theirs = jax._multi_world_frame(per_world, [JaxPhysics(seed=s) for s in jax.TRAIN_WORLD_SEEDS], None,
                                    with_frags=with_frags)
    assert_frame_equal(ours[0], theirs[0])
    if with_frags:
        assert len(ours[1]["type"]) > 1000
        assert_frame_equal(ours[1], theirs[1])
    else:
        assert all(len(v) == 0 for v in ours[1].values()) and len(theirs[1]) == 0


def test_gates_give_jax_values_on_the_packaged_weights(jax, packaged, capsys):
    from alphadia_tpu.testing.physics import PeptidePhysics as JaxPhysics

    mgr, jmgr = packaged
    seqs = port._unseen(101, 400, set())
    for seed in (port.TRAIN_WORLD_SEEDS[0], port.EVAL_WORLD_SEED):
        assert_close(port._eval_world(mgr, seqs, PeptidePhysics(seed=seed), None, "w"),
                     jax._eval_world(jmgr, seqs, JaxPhysics(seed=seed), None, "w"))
    ours = port._published_constants_gates(mgr, seqs)
    assert_close(ours, jax._published_constants_gates(jmgr, seqs))
    assert ours["ok"]


def test_a_tiny_run_below_the_bars_writes_nothing(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(port, "train", functools.partial(port.train, **TINY))
    assert port.main(["--out", str(tmp_path), "--device", "cpu"]) == 1
    assert "NOT packaging" in capsys.readouterr().out
    assert not list(tmp_path.iterdir())


def test_a_tiny_run_writes_what_jax_reads(tmp_path, monkeypatch):
    from alphadia_tpu.models.finetune import FinetuneManager as JaxFinetuneManager

    monkeypatch.setattr(port, "passes_bars", lambda within, cross, pub: True)
    monkeypatch.setattr(port, "train", functools.partial(port.train, **TINY))
    assert port.main(["--out", str(tmp_path), "--device", "cpu"]) == 0
    ours, theirs = FinetuneManager.load(tmp_path, device="cpu"), JaxFinetuneManager.load(tmp_path)
    assert {"rt", "charge", "ms2", "ccs", "holdout", "cross_world", "published_constants"} <= set(ours.metrics)
    seqs = port._unseen(7, 64, set())
    n, z = len(seqs), np.full(len(seqs), 2, np.int32)
    for a, b in (
        (ours.predict_rt(seqs), theirs.predict_rt(seqs)),
        (ours.predict_charge(seqs), theirs.predict_charge(seqs)),
        (ours.predict_ms2(seqs, [""] * n, [""] * n, z), theirs.predict_ms2(seqs, [""] * n, [""] * n, z)),
        (ours.predict_mobility(seqs, [""] * n, [""] * n, z), theirs.predict_mobility(seqs, [""] * n, [""] * n, z)),
    ):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def test_revalidate_writes_the_packaged_weights_with_jax_readings(jax, packaged, tmp_path, monkeypatch):
    monkeypatch.setattr(port, "EVAL_SEQUENCES", 300)
    assert port.revalidate(tmp_path, "cpu")
    saved = pickle.loads((tmp_path / "models.pkl").read_bytes())
    packaged_state = pickle.loads((port.OUT_DIR / "models.pkl").read_bytes())
    for name, tree in packaged_state["variables"].items():
        flat = pd.json_normalize(tree, sep="/").iloc[0].to_dict()
        flat_saved = pd.json_normalize(saved["variables"][name], sep="/").iloc[0].to_dict()
        for k, v in flat.items():
            assert np.asarray(flat_saved[k]).tobytes() == np.asarray(v).tobytes(), (name, k)
    want = jax._published_constants_gates(packaged[1], port._unseen(101, 300, set()))
    assert_close(saved["metrics"]["published_constants"], want)
    assert saved["metrics"]["cross_world"]["krokhin_spearman"] == saved["metrics"]["published_constants"][
        "krokhin_spearman"]


def test_retrain_charge_replaces_only_the_charge_model(tmp_path, monkeypatch):
    monkeypatch.setattr(port, "SEQUENCES_PER_WORLD", 300)
    monkeypatch.setattr(port, "EVAL_SEQUENCES", 200)
    monkeypatch.setattr(port, "CONFIG", {**port.CONFIG, "epochs": 2})
    # 2 epochs on 900 sequences: below the charge priors' gate, nothing written
    assert not port.retrain_charge(tmp_path, "cpu")
    assert not list(tmp_path.iterdir())
    monkeypatch.setattr(port, "_published_constants_gates", lambda mgr, seqs: {"ok": True})
    assert port.retrain_charge(tmp_path, "cpu")
    packaged_state = pickle.loads((port.OUT_DIR / "models.pkl").read_bytes())
    saved = pickle.loads((tmp_path / "models.pkl").read_bytes())
    for name in ("rt", "ms2", "ccs", "charge"):
        same = [np.array_equal(a, b) for a, b in zip(
            pd.json_normalize(saved["variables"][name], sep="/").iloc[0].to_list(),
            pd.json_normalize(packaged_state["variables"][name], sep="/").iloc[0].to_list())]
        assert all(same) == (name != "charge"), name


# ---------------------------------------------------------------------------
# readings of phase [17c]
# ---------------------------------------------------------------------------
def jax_readings(cut: dict) -> dict:
    """JAX's ``main`` at ``cut`` through its helpers, without the write."""
    from alphadia_tpu.models.finetune import FinetuneManager as JaxFinetuneManager

    jax = jax_script()
    train_worlds = [jax.PeptidePhysics(seed=s) for s in jax.TRAIN_WORLD_SEEDS]
    rng, per_world, seen = np.random.default_rng(11), [], set()
    for _ in jax.TRAIN_WORLD_SEEDS:
        seqs = [s for s in dict.fromkeys(jax._tryptic_sequences(rng, cut["sequences_per_world"])) if s not in seen]
        seen.update(seqs)
        per_world.append(seqs)
    n_eval = cut["eval_sequences"]
    holdout = [s for s in dict.fromkeys(jax._tryptic_sequences(np.random.default_rng(99), n_eval)) if s not in seen]
    xworld = [s for s in dict.fromkeys(jax._tryptic_sequences(np.random.default_rng(101), n_eval)) if s not in seen]
    psm, frag = jax._multi_world_frame(per_world, train_worlds, rng)
    mgr = JaxFinetuneManager(config={**port.CONFIG, "epochs": cut["epochs"]}, random_state=0)
    mgr.finetune_rt(psm)
    mgr.finetune_charge(psm)
    sub_idx = np.sort(np.random.default_rng(7).choice(len(psm), min(cut["ms2_subset"], len(psm)), replace=False))
    keep = np.zeros(len(psm), bool)
    keep[sub_idx] = True
    sub, sub_frag = psm.iloc[sub_idx], frag[keep[frag["precursor_idx"].to_numpy()]]
    mgr.finetune_ms2(sub, sub_frag)
    mgr.finetune_ccs(sub)
    within = jax._eval_world(mgr, holdout, train_worlds[0], rng, "within-world")
    cross = jax._eval_world(mgr, xworld, jax.PeptidePhysics(seed=jax.EVAL_WORLD_SEED), rng, "cross-world")
    pub = jax._published_constants_gates(mgr, xworld)
    return port.summary(mgr.metrics, within, cross, pub)


def main():
    ap = argparse.ArgumentParser(description="phase [17c]'s readings at its cut")
    ap.add_argument("--jax", action="store_true", help="JAX's helpers on the CPU")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--full", action="store_true", help="at the packaged run's size, not the cut")
    opt = ap.parse_args()
    cut = FULL if opt.full else CUT
    if opt.jax:
        print(json.dumps(jax_readings(cut)), flush=True)
    else:
        r = port.train(device=opt.device, write=False, **cut)
        print(json.dumps(port.summary(r["mgr"].metrics, r["within"], r["cross"], r["pub"])), flush=True)


if __name__ == "__main__":
    main()
