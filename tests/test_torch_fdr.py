"""The port's FDR stack against the JAX package's on the CPU, on the same
frames (pandas there, column dicts here):

- ``get_q_values``, ``keep_best`` and ``FragmentCompetition``: the same
  rows in the same order and the same q-values, exactly, on frames with
  tied scores, several channels and PSMs in no isolation window;
- ``perform_fdr`` with a stub classifier (a fixed probability per PSM,
  with ties): identical rows, order and q-values, fragment competition
  included;
- the logistic fallback against scikit-learn: probabilities within 1e-4,
  the same IDs at 1% FDR;
- the network path on the JAX test's synthetic PSMs (two Gaussian
  classes): IDs at 1% FDR within 3% of JAX's count, Jaccard >= 0.95 (the
  two fits draw different dropout masks, so they agree statistically).
"""

import numpy as np
import pandas as pd
import pytest
from sklearn.linear_model import LogisticRegression

from alphadia_torch.fdr.fdr import balanced_logistic_proba, perform_fdr
from alphadia_torch.fdr.fragcomp import FragmentCompetition
from alphadia_torch.fdr.qvalues import fdr_to_q_values, get_q_values, keep_best
from alphadia_torch.models.classifier import BinaryClassifier
from alphadia_tpu.fdr import get_q_values as jax_get_q_values
from alphadia_tpu.fdr import keep_best as jax_keep_best
from alphadia_tpu.fdr import perform_fdr as jax_perform_fdr
from alphadia_tpu.fdr.fragcomp import FragmentCompetition as JaxFragmentCompetition
from alphadia_tpu.models.classifier import BinaryClassifier as JaxBinaryClassifier

pytest_plugins = ("torch_port_plugin",)


def _frame(df: pd.DataFrame) -> dict:
    return {c: df[c].to_numpy() for c in df.columns}


def assert_same_rows(ours: dict, theirs: pd.DataFrame, columns=None):
    columns = columns or list(theirs.columns)
    assert len(ours[columns[0]]) == len(theirs)
    for c in columns:
        np.testing.assert_array_equal(ours[c], theirs[c].to_numpy(), err_msg=c)


def _psms(n=400, seed=0, n_channels=2):
    """PSMs with coarse (tied) probabilities, several channels, RTs close
    enough to compete, and some m/z outside every isolation window."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame(
        {
            "precursor_idx": rng.permutation(n) // 2,
            "rank": rng.integers(0, 3, n),
            "elution_group_idx": rng.integers(0, n // 4, n),
            "channel": rng.integers(0, n_channels, n) * 4,
            "proba": np.round(rng.uniform(0, 1, n), 2),
            "_decoy": rng.integers(0, 2, n).astype(np.float32),
            "rt_observed": rng.uniform(0, 30, n),
            "mz_observed": rng.choice([450.0, 550.0, 650.0, 9999.0], n),
        }
    )


def _cycle():
    cycle = np.zeros((1, 4, 1, 2))
    cycle[0, 0, 0] = [-1, -1]
    cycle[0, 1, 0] = [400, 500]
    cycle[0, 2, 0] = [500, 600]
    cycle[0, 3, 0] = [600, 700]
    return cycle


def _fragments(psm: pd.DataFrame, seed=1):
    rng = np.random.default_rng(seed)
    pool = np.array([210.0, 220.0, 230.0, 240.0, 250.0, 260.0, 270.0])
    keys = psm[["precursor_idx", "rank"]].drop_duplicates()
    rows = np.repeat(np.arange(len(keys)), 4)
    return pd.DataFrame(
        {
            "precursor_idx": keys["precursor_idx"].to_numpy()[rows],
            "rank": keys["rank"].to_numpy()[rows],
            "mz": rng.choice(pool, len(rows)),
        }
    )


def test_fdr_to_q_values():
    fdr = np.array([0.1, 0.05, 0.3, 0.2, 0.4])
    np.testing.assert_allclose(fdr_to_q_values(fdr), [0.05, 0.05, 0.2, 0.2, 0.4])


@pytest.mark.parametrize("seed", [0, 1])
def test_get_q_values_and_keep_best_match_jax(seed):
    df = _psms(seed=seed)
    theirs = jax_get_q_values(df.copy())
    ours = get_q_values(_frame(df))
    assert_same_rows(ours, theirs)
    for groups in (None, ["elution_group_idx", "channel"], ["elution_group_idx"], ["precursor_idx"]):
        assert_same_rows(keep_best(ours, group_columns=groups), jax_keep_best(theirs, group_columns=groups))


def test_fragment_competition_matches_jax():
    df = _psms(n=300, seed=3)
    frag = _fragments(df)
    theirs = JaxFragmentCompetition()(df, frag, _cycle())
    ours = FragmentCompetition()(_frame(df), _frame(frag), _cycle())
    assert 0 < len(theirs) < len(df)
    assert_same_rows(ours, theirs)
    # the frame's own row index orders the survivors, as pandas' index does
    shuffled = df.sample(frac=1.0, random_state=4)
    theirs = JaxFragmentCompetition()(shuffled, frag, _cycle())
    ours = FragmentCompetition()({**_frame(shuffled), "_row": shuffled.index.to_numpy()}, _frame(frag), _cycle())
    assert_same_rows(ours, theirs)


class StubClassifier:
    """A fixed probability per PSM, a function of its features (ties on
    purpose); ``fit`` learns nothing."""

    fitted = True

    def fit(self, x, y):
        pass

    def predict_proba(self, x):
        p = np.round(1.0 / (1.0 + np.exp(x[:, 0] - x[:, 1])), 2).astype(np.float32)
        return np.stack([1 - p, p], 1)


def _labelled(n=1200, seed=5):
    df = _psms(n=n, seed=seed).drop(columns=["proba", "_decoy"])
    rng = np.random.default_rng(seed)
    df["decoy"] = rng.integers(0, 2, n)
    df["f0"] = rng.normal(0, 1, n) + 1.5 * (df["decoy"] == 0)
    df["f1"] = rng.normal(0, 1, n)
    df["mz_library"] = df["mz_observed"]
    return df


@pytest.mark.parametrize("competitive", [True, False])
def test_perform_fdr_with_stub_classifier_matches_jax(competitive):
    df = _labelled()
    frag = _fragments(df)
    kw = dict(competitive=competitive, dia_cycle=_cycle(), random_state=0)
    t, d = df[df["decoy"] == 0], df[df["decoy"] == 1]
    theirs = jax_perform_fdr(StubClassifier(), ["f0", "f1"], t, d, df_fragments=frag, **kw)
    ours = perform_fdr(StubClassifier(), ["f0", "f1"], _frame(t), _frame(d), df_fragments=_frame(frag), **kw)
    assert theirs.attrs["fdr_estimator"] == ours.attrs["fdr_estimator"] == "nn"
    assert 0 < len(theirs) < len(df)
    assert sorted(ours) == sorted(theirs.columns)
    assert_same_rows(ours, theirs)


def test_logistic_fallback_matches_sklearn():
    rng = np.random.default_rng(2)
    n_t, n_d = 300, 40
    x = np.concatenate([rng.normal(0.8, 1, (n_t, 6)), rng.normal(0, 1, (n_d, 6))]).astype(np.float32)
    y = np.concatenate([np.zeros(n_t), np.ones(n_d)]).astype(np.float32)
    mu, sd = x.mean(0), x.std(0) + 1e-9
    xz = (x - mu) / sd
    sk = LogisticRegression(class_weight="balanced", max_iter=1000, random_state=0).fit(xz, y).predict_proba(xz)[:, 1]
    np.testing.assert_allclose(balanced_logistic_proba(xz, y), sk, rtol=0, atol=1e-4)
    assert balanced_logistic_proba(xz, y).dtype == sk.dtype == np.float32

    cols = [f"f{i}" for i in range(6)]
    t = pd.DataFrame(x[:n_t], columns=cols).assign(precursor_idx=np.arange(n_t), elution_group_idx=np.arange(n_t), channel=0)
    d = pd.DataFrame(x[n_t:], columns=cols).assign(
        precursor_idx=n_t + np.arange(n_d), elution_group_idx=n_t + np.arange(n_d), channel=0
    )
    theirs = jax_perform_fdr(JaxBinaryClassifier(random_state=0), cols, t, d, competitive=True)
    ours = perform_fdr(BinaryClassifier(random_state=0, device="cpu"), cols, _frame(t), _frame(d), competitive=True)
    assert theirs.attrs["fdr_estimator"] == ours.attrs["fdr_estimator"] == "logistic"
    a = dict(zip(theirs["precursor_idx"], theirs["proba"]))
    np.testing.assert_allclose(ours["proba"], [a[p] for p in ours["precursor_idx"]], rtol=0, atol=1e-4)
    ids = set(theirs["precursor_idx"][(theirs["qval"] <= 0.01) & (theirs["_decoy"] == 0)])
    assert set(ours["precursor_idx"][(ours["qval"] <= 0.01) & (ours["_decoy"] == 0)]) == ids


def _synthetic_psm(n=2000, n_features=10, seed=1, separation=1.5):
    """``tests/unit/test_fdr.py``'s two Gaussian classes."""
    rng = np.random.default_rng(seed)
    cols = [f"f{i}" for i in range(n_features)]
    t = pd.DataFrame(rng.normal(separation, 1.0, (n, n_features)), columns=cols)
    d = pd.DataFrame(rng.normal(0.0, 1.0, (n, n_features)), columns=cols)
    for df, dec in ((t, 0), (d, 1)):
        df["precursor_idx"] = np.arange(len(df)) * 2 + dec
        df["elution_group_idx"] = np.arange(len(df))
        df["channel"] = 0
    return t, d, cols


def test_network_path_ids_agree_with_jax():
    t, d, cols = _synthetic_psm()
    theirs = jax_perform_fdr(JaxBinaryClassifier(random_state=0, epochs=5), cols, t, d, competitive=True, random_state=0)
    ours = perform_fdr(
        BinaryClassifier(random_state=0, epochs=5, device="cpu"), cols, _frame(t), _frame(d),
        competitive=True, random_state=0,
    )
    assert theirs.attrs["fdr_estimator"] == ours.attrs["fdr_estimator"] == "nn"
    ids_j = set(theirs["precursor_idx"][(theirs["qval"] < 0.01) & (theirs["_decoy"] == 0)])
    ids = set(ours["precursor_idx"][(ours["qval"] < 0.01) & (ours["_decoy"] == 0)])
    assert len(ids_j) > 1000
    assert abs(len(ids) - len(ids_j)) <= 0.03 * len(ids_j)
    assert len(ids & ids_j) / len(ids | ids_j) >= 0.95


def test_small_and_one_sided_sets():
    """The JAX test's fallbacks: the logistic fit from two decoys up, and
    q-values 0 without decoys; without targets every q-value is 1."""
    t, d, cols = _synthetic_psm(n=5)
    clf = BinaryClassifier(random_state=0, device="cpu")
    for dd, estimator in ((d, "logistic"), (d.iloc[:2], "logistic"), (d.iloc[:0], "no_decoy")):
        out = perform_fdr(clf, cols, _frame(t), _frame(dd))
        assert out.attrs["fdr_estimator"] == estimator
        assert ((out["qval"] >= 0) & (out["qval"] <= 1)).all()
        if estimator == "no_decoy":
            assert (out["qval"] == 0.0).all()
    out = perform_fdr(clf, cols, _frame(t.iloc[:0]), _frame(d))
    assert out.attrs["fdr_estimator"] == "no_target" and (out["qval"] == 1.0).all()
    assert not clf.fitted
