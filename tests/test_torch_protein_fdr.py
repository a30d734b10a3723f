"""The protein FDR and ``fdrx`` of the port against the JAX package (and
scikit-learn, whose classifier the JAX package fits), on the CPU.

- ``outputs/mlp``: ``StandardScaler`` equals scikit-learn's within 1e-12
  (a constant feature gets scale 1); ``MLPClassifier`` (numpy float64) gives
  scikit-learn's ``predict_proba`` within 1e-9 after the same number of
  epochs, on balanced and unbalanced data, one to seven features;
- ``perform_protein_fdr`` on the cases of ``tests/unit/test_outputs.py``
  and on a table with shared groups and several runs: the same rows in the
  same order, ``pg_qval`` within 1e-9, the same accepted set at 1%; too few
  proteins raise ``TooFewProteinsError`` in both;
- ``fdr/fdrx`` on the cases of ``tests/unit/test_fdrx.py``, with the same
  scikit-learn estimator in both packages: equal q-values, PEPs and rows.
"""

import numpy as np
import pandas as pd
import pytest
from sklearn.linear_model import LogisticRegression
from sklearn.neural_network import MLPClassifier as SkMLP
from sklearn.preprocessing import StandardScaler as SkScaler

from alphadia_torch.exceptions import TooFewProteinsError
from alphadia_torch.fdr import fdrx
from alphadia_torch.outputs.mlp import MLPClassifier, StandardScaler
from alphadia_torch.outputs.protein_fdr import perform_protein_fdr
from alphadia_tpu.exceptions import TooFewProteinsError as JaxTooFewProteinsError
from alphadia_tpu.fdr import fdrx as jax_fdrx
from alphadia_tpu.outputs.protein_fdr import perform_protein_fdr as jax_perform_protein_fdr

pytest_plugins = ("torch_port_plugin",)


def _frame(df: pd.DataFrame) -> dict:
    return {c: df[c].to_numpy() for c in df.columns}


def _xy(n, d, seed, decoy_share):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < decoy_share).astype(np.int64)
    x = rng.normal(size=(n, d)) + y[:, None] * rng.uniform(0.5, 2.0, d)
    x[:, 0] = np.round(np.abs(x[:, 0]) * 3)  # a count-like column
    return x, y


@pytest.mark.parametrize("n,d,seed,decoy_share", [(60, 7, 0, 0.5), (250, 7, 1, 0.2), (410, 3, 2, 0.05), (90, 1, 3, 0.4)])
def test_mlp_matches_scikit_learn(n, d, seed, decoy_share):
    x, y = _xy(n, d, seed, decoy_share)
    theirs = SkMLP(random_state=0, max_iter=300).fit(x, y)
    ours = MLPClassifier(random_state=0, max_iter=300).fit(x, y)
    assert ours.n_iter_ == theirs.n_iter_
    np.testing.assert_allclose(ours.loss_curve_, theirs.loss_curve_, rtol=1e-10, atol=0)
    xt = np.random.default_rng(seed + 10).normal(size=(50, d))
    np.testing.assert_allclose(ours.predict_proba(xt), theirs.predict_proba(xt), rtol=0, atol=1e-9)


def test_scaler_matches_scikit_learn():
    x, _ = _xy(120, 6, 4, 0.3)
    x[:, 2] = 3.0  # constant: scale 1
    x[:, 3] *= 1e6
    theirs, ours = SkScaler().fit(x), StandardScaler().fit(x)
    np.testing.assert_allclose(ours.mean_, theirs.mean_, rtol=1e-12)
    np.testing.assert_allclose(ours.scale_, theirs.scale_, rtol=1e-12)
    assert ours.scale_[2] == 1.0
    np.testing.assert_allclose(ours.transform(x), theirs.transform(x), rtol=0, atol=1e-12)


def _separating_psm(n=150, seed=0):
    """The table of ``tests/unit/test_outputs.py::test_protein_fdr_separates``."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        for decoy in (0, 1):
            proba = rng.uniform(0, 0.4) if decoy == 0 else rng.uniform(0.5, 1.0)
            n_prec = rng.integers(2, 8) if decoy == 0 else 1
            for j in range(n_prec):
                rows.append({
                    "precursor_idx": i * 100 + decoy * 50 + j, "pg": f"PG{i}_{decoy}", "genes": f"G{i}",
                    "proteins": f"P{i}", "sequence": f"SEQ{i}_{j}", "decoy": decoy,
                    "proba": proba + rng.normal(0, 0.02), "run": "r1",
                })
    return pd.DataFrame(rows)


def _overlapping_psm(seed=5):
    """Groups whose scores overlap, float32 probabilities, two runs, groups
    shared across runs, several precursors per peptide."""
    rng = np.random.default_rng(seed)
    rows = []
    for run in ("run_b", "run_a"):
        for i in range(90):
            decoy = int(i % 3 == 0)
            for j in range(1 + i % 4):
                rows.append({
                    "precursor_idx": i * 10 + j, "pg": f"PG{i % 70};PG{i % 5}" if i % 7 == 0 else f"PG{i % 70}",
                    "genes": f"G{i}", "proteins": f"P{i}", "sequence": f"SEQ{i}_{j // 2}", "decoy": decoy,
                    "proba": np.float32(np.clip(rng.normal(0.55 if decoy else 0.35, 0.2), 0, 1)), "run": run,
                })
    df = pd.DataFrame(rows)
    df["proba"] = df["proba"].astype(np.float32)
    return df


@pytest.mark.parametrize("case", ["separating", "overlapping"])
def test_protein_fdr_matches_jax(case):
    df = _separating_psm() if case == "separating" else _overlapping_psm()
    theirs = jax_perform_protein_fdr(df.copy())
    ours = perform_protein_fdr(_frame(df))
    assert list(ours) == list(theirs.columns)
    for c in ("precursor_idx", "pg", "decoy", "run"):
        np.testing.assert_array_equal(ours[c], theirs[c].to_numpy(), err_msg=c)
    np.testing.assert_allclose(ours["pg_qval"], theirs["pg_qval"].to_numpy(), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ours["pg_qval"] <= 0.01, theirs["pg_qval"].to_numpy() <= 0.01)
    if case == "separating":
        accepted = ours["pg"][(ours["decoy"] == 0) & (ours["pg_qval"] <= 0.01)]
        assert len(set(accepted)) > 100


def test_too_few_proteins_raise_in_both():
    df = _separating_psm(n=150).query("decoy == 0 or pg == 'PG0_1'")
    with pytest.raises(JaxTooFewProteinsError):
        jax_perform_protein_fdr(df.copy())
    with pytest.raises(TooFewProteinsError):
        perform_protein_fdr(_frame(df))


def _fdrx_psm(n=400, seed=0):
    rng = np.random.default_rng(seed)
    half = n // 2
    return pd.DataFrame({
        "precursor_idx": np.arange(n),
        "f1": np.concatenate([rng.normal(2, 1, half), rng.normal(-2, 1, half)]),
        "f2": np.concatenate([rng.normal(1, 1, half), rng.normal(-1, 1, half)]),
        "decoy": np.concatenate([np.zeros(half), np.ones(half)]).astype(int),
        "elution_group_idx": np.arange(n) // 2,
        "channel": 0,
    })


def _fragment_case(df):
    df["rank"] = 0
    df["rt_observed"] = np.linspace(100, 400, len(df))
    df["mz_library"] = np.where(df["precursor_idx"] % 2 == 0, 450.0, 550.0)
    frag = pd.DataFrame({
        "precursor_idx": np.repeat(df["precursor_idx"].to_numpy(), 4),
        "rank": 0,
        "mz": np.tile([200.0, 300.0, 400.0, 500.0], len(df)) + np.repeat(df["precursor_idx"].to_numpy(), 4) * 1e-3,
    })
    cycle = np.zeros((1, 3, 1, 2))
    cycle[0, 1, 0] = [400, 500]
    cycle[0, 2, 0] = [500, 600]
    cycle[0, 0, 0] = [-1, -1]
    return df, frag, cycle


@pytest.mark.parametrize("case", ["plain", "nan_rows", "competition", "fragment_competition", "mobility_cycle"])
def test_fdrx_matches_jax(case):
    df, frag, cycle, competition = _fdrx_psm(), None, None, []
    if case == "nan_rows":
        df = _fdrx_psm(100)
        df.loc[:4, "f1"] = np.nan
    if case in ("competition", "fragment_competition", "mobility_cycle"):
        competition = ["elution_group_idx"]
    if case == "fragment_competition":
        df, frag, cycle = _fragment_case(_fdrx_psm(200, seed=3))
    if case == "mobility_cycle":
        df, frag, cycle = _fragment_case(_fdrx_psm(100, seed=4))
        cycle = np.zeros((1, 2, 8, 2))
    theirs = jax_fdrx.TargetDecoyFDR(LogisticRegression(max_iter=500), ["f1", "f2"], competition_columns=competition)
    ours = fdrx.TargetDecoyFDR(LogisticRegression(max_iter=500), ["f1", "f2"], competition_columns=competition)
    want = theirs.fit_predict_qval(df.copy(), None if frag is None else frag.copy(), cycle)
    got = ours.fit_predict_qval(_frame(df), None if frag is None else _frame(frag), cycle)
    assert set(got) == set(want.columns)
    np.testing.assert_array_equal(got["precursor_idx"], want["precursor_idx"].to_numpy())
    for c in ("decoy_proba", "qval", "pep"):
        np.testing.assert_allclose(got[c], want[c].to_numpy(), rtol=0, atol=1e-12, err_msg=c)
    if case == "nan_rows":
        assert (ours.predict_classifier(_frame(df))[:5] == 1.0).all()


@pytest.mark.parametrize("ratio", [1.0, 3.0])
def test_add_q_values_and_pep_match_jax(ratio):
    rng = np.random.default_rng(1)
    df = pd.DataFrame({"precursor_idx": np.arange(40), "decoy_proba": rng.uniform(0, 1, 40), "decoy": [0, 0, 0, 1] * 10})
    want = jax_fdrx.add_q_values(df.copy(), r_target_decoy=ratio)
    got = fdrx.add_q_values(_frame(df), r_target_decoy=ratio)
    np.testing.assert_array_equal(got["precursor_idx"], want["precursor_idx"].to_numpy())
    np.testing.assert_allclose(got["qval"], want["qval"].to_numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(fdrx.get_pep(got), jax_fdrx.get_pep(want), rtol=0, atol=0)
