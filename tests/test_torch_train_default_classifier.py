"""The port's default-classifier trainer
(``alphadia_torch/scripts/train_default_classifier.py``) against the JAX
package's ``scripts/train_default_classifier.py``, loaded by path. Only
the JAX script's helpers are called: its ``main`` writes into the JAX
package's ``constants/``.

- the corpora are JAX's; a corpus's search gives JAX's PSMs (candidates
  equal, features at the scoring tests' tolerances);
- the subset of ``_first_iteration_ids`` is pandas' ``sample`` row for row,
  and the function gives JAX's count on the same frame (a held-out
  corpus's PSMs), warm from the packaged state and cold;
- ``main`` run at 60 peptides a corpus and 2 epochs on the CPU writes
  ``<feature hash>.pkl``, which JAX's ``BinaryClassifier.from_state_dict``
  reads and which predicts there what the port predicts (1e-5).

Run as a script it prints the readings that ``chip_smoke.py`` phase [17b]
gates against: JAX's helpers at the packaged size on the CPU, and the
port's trainer at classifier random states 0-5 (``--port``):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train_default_classifier.py [--port --device cpu]
"""

import argparse
import functools
import importlib.util
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from alphadia_torch.convert import frame_from_pandas
from alphadia_torch.models.classifier import BinaryClassifier
from alphadia_torch.scripts import train_default_classifier as port
from alphadia_torch.workflow.peptidecentric.peptidecentric import FDR_FEATURE_COLUMNS
from alphadia_tpu.models.classifier import BinaryClassifier as JaxBinaryClassifier

pytest_plugins = ("torch_port_plugin",)

REPO = Path(__file__).resolve().parents[1]
PACKAGED_NAME = "ea4b0fe1c1f77109.pkl"
BF16_STEP = 2.0**-7
F16_STEP = 2.0**-10
MASS_ERRORS = (
    "weighted_mass_deviation", "weighted_mass_error", "top_3_ms2_mass_error",
    "mean_ms2_mass_error", "mean_overlapping_mass_error",
)


def jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_default_classifier",
                                                  REPO / "scripts" / "train_default_classifier.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax():
    return jax_script()


def test_corpora_are_jax_corpora(jax):
    assert port.TRAIN_CORPORA == jax.TRAIN_CORPORA
    assert port.EVAL_CORPORA == jax.EVAL_CORPORA


def test_a_corpus_search_gives_jax_psms(jax):
    from alphadia_tpu.ops.scoring import _BF16_FEATURES
    from alphadia_tpu.search.scoring import FEATURE_COLUMNS

    corpus = port.TRAIN_CORPORA[1]
    theirs = jax._search(corpus, n_peptides=60)
    ours = port._search(corpus, n_peptides=60, device="cpu")
    # the port's synthetic library has no xxhash columns (nothing on the path reads them)
    columns = [c for c in theirs.columns if c not in ("mod_seq_hash", "mod_seq_charge_hash")]
    assert sorted(ours) == sorted(columns)
    assert len(ours["precursor_idx"]) == len(theirs) > 50
    bf16 = {FEATURE_COLUMNS[i] for i in _BF16_FEATURES}
    for c in columns:
        a, b = ours[c], theirs[c].to_numpy()
        if c in MASS_ERRORS:
            np.testing.assert_allclose(a, b, rtol=0, atol=0.06, err_msg=c)
        elif c in FEATURE_COLUMNS:
            scale = np.maximum(np.abs(b.astype(np.float64)), 1.0)
            assert (np.abs(a - b) <= (BF16_STEP if c in bf16 else 2e-3) * scale).all(), c
        elif c == "score":
            np.testing.assert_allclose(a, b, rtol=F16_STEP, atol=1e-3, err_msg=c)
        elif b.dtype == object:
            assert [str(x) for x in a] == [str(x) for x in b], c
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)


@pytest.fixture(scope="module")
def eval_psm():
    """The port's PSMs of the second held-out corpus at 300 peptides, and
    the same frame in pandas."""
    psm = port._search(port.EVAL_CORPORA[1], n_peptides=300, device="cpu")
    return psm, pd.DataFrame({c: list(v) if v.dtype == object else v for c, v in psm.items()})


def test_sample_is_pandas_sample(eval_psm):
    psm, df = eval_psm
    for seed in (0, 101, 113):
        want = frame_from_pandas(df.sample(n=300, random_state=seed).reset_index(drop=True))
        got = port._sample(psm, 300, seed)
        for c in want:
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_first_iteration_ids_match_jax(jax, eval_psm, warm):
    """One frame, each package's subset, fit and count (the network: more
    than 500 PSMs, more than 50 decoys)."""
    psm, df = eval_psm
    assert len(df) > 500 and df["decoy"].sum() > 50
    state = pickle.loads((REPO / "alphadia_torch" / "constants" / "classifier" / PACKAGED_NAME).read_bytes())
    theirs = jax._first_iteration_ids(df, state if warm else None, seed=113)
    ours = port._first_iteration_ids(psm, state if warm else None, seed=113, device="cpu")
    assert theirs > 100
    assert ours == theirs


def test_a_tiny_run_writes_what_jax_reads(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(port, "train", functools.partial(port.train, n_peptides=60, epochs=2))
    rc = port.main(["--out", str(tmp_path), "--device", "cpu"])
    assert rc == 0, capsys.readouterr().out
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == [PACKAGED_NAME]
    state = pickle.loads(files[0].read_bytes())
    x = np.random.default_rng(0).normal(0, 1, (200, state["input_dim"])).astype(np.float32)
    ours = BinaryClassifier.from_state_dict(state, "cpu").predict_proba(x)
    theirs = np.asarray(JaxBinaryClassifier.from_state_dict(state).predict_proba(x))
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
    assert ours[:, 1].std() > 0  # a fitted network, not a constant


# ---------------------------------------------------------------------------
# readings of phase [17b]
# ---------------------------------------------------------------------------
def jax_readings() -> dict:
    """JAX's helpers at the packaged size, as its ``main`` runs them, without
    the write."""
    jax = jax_script()
    features = [jax._search(c) for c in jax.TRAIN_CORPORA]
    df = pd.concat(features, ignore_index=True)
    available = [c for c in FDR_FEATURE_COLUMNS if c in df.columns]
    X = np.nan_to_num(df[available].to_numpy(np.float32))
    y = df["decoy"].to_numpy(np.float32)
    clf = JaxBinaryClassifier(random_state=0, epochs=20)
    clf.fit(X, y)
    proba = np.asarray(clf.predict_proba(X))[:, 1]
    out = {"n_psms": len(X), "separation": float(proba[y == 1].mean() - proba[y == 0].mean())}
    state = clf.to_state_dict()
    for corpus in jax.EVAL_CORPORA:
        psm = jax._search(corpus)
        out[f"warm_{corpus['seed']}"] = jax._first_iteration_ids(psm, state, seed=corpus["seed"])
        out[f"cold_{corpus['seed']}"] = jax._first_iteration_ids(psm, None, seed=corpus["seed"])
    return out


def port_readings(states, device) -> list[dict]:
    """The port's trainer at each classifier random state, without writing
    (the corpora searched once)."""
    searched = {}
    real = port._search

    def once(corpus, n_peptides=port.N_PEPTIDES, device=None):
        key = corpus["seed"]
        if key not in searched:
            searched[key] = real(corpus, n_peptides, device)
        return searched[key]

    port._search = once
    try:
        rows = []
        for state in states:
            r = port.train(device=device, random_state=state, write=False)
            row = {"random_state": state, "n_psms": r["n_psms"], "separation": r["separation"]}
            for seed, (warm, cold) in r["eval"].items():
                row[f"warm_{seed}"], row[f"cold_{seed}"] = warm, cold
            rows.append(row)
        return rows
    finally:
        port._search = real


def main():
    ap = argparse.ArgumentParser(description="phase [17b]'s readings")
    ap.add_argument("--port", action="store_true", help="the port's trainer at random states 0-5")
    ap.add_argument("--device", default="cpu")
    opt = ap.parse_args()
    if opt.port:
        for row in port_readings(range(6), opt.device):
            print(json.dumps(row), flush=True)
    else:
        print(json.dumps(jax_readings()), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).parent))
    main()
