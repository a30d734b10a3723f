"""The port's ``FDRManager`` on the CPU: the cases of
``tests/unit/test_fdr_manager.py`` (versions accumulate; a given version
scores without retraining; the warm start; the packaged classifier for
``FDR_FEATURE_COLUMNS``; channel-wise q-values; a fallback fit stores
nothing; save and load), and the pure-Python xxh64 that keys the packaged
classifiers against the ``xxhash`` package (identical digests).
"""

import numpy as np
import pytest
import xxhash

from alphadia_torch.models.classifier import BinaryClassifier
from alphadia_torch.utils.frame import take
from alphadia_torch.utils.hashing import xxh64_hexdigest
from alphadia_torch.workflow.managers.fdr_manager import FDRManager
from alphadia_torch.workflow.peptidecentric.peptidecentric import FDR_FEATURE_COLUMNS
from alphadia_tpu.workflow.peptidecentric.peptidecentric import FDR_FEATURE_COLUMNS as JAX_FDR_FEATURE_COLUMNS

pytest_plugins = ("torch_port_plugin",)

N_FEAT = 6
COLS = [f"feat_{i}" for i in range(N_FEAT)]


def _features(n=600, seed=0, channels=(0,)):
    rng = np.random.default_rng(seed)
    half = n // 2
    x = np.concatenate([rng.normal(1.0, 1.0, (half, N_FEAT)), rng.normal(-1.0, 1.0, (half, N_FEAT))])
    df = {c: x[:, i] for i, c in enumerate(COLS)}
    df.update(
        decoy=np.repeat([0, 1], half), precursor_idx=np.arange(n), elution_group_idx=np.arange(n),
        channel=np.resize(np.asarray(channels), n), rank=np.zeros(n, np.int64),
    )
    return df


def _matrix(df):
    return np.stack([df[c] for c in COLS], 1).astype(np.float32)


def _manager(tmp_path=None, **kw):
    return FDRManager(
        feature_columns=COLS,
        classifier_base=BinaryClassifier(random_state=0, epochs=4, device="cpu"),
        path=None if tmp_path is None else tmp_path / "fdr_manager.pkl",
        random_state=0,
        **kw,
    )


def test_fit_predict_versions_accumulate():
    mgr = _manager()
    assert mgr.current_version == -1
    for version, seed in ((0, 1), (1, 2)):
        out = mgr.fit_predict(_features(seed=seed))
        assert mgr.current_version == version
        assert out.attrs["fdr_estimator"] == "nn"
        assert {"qval", "proba"} <= set(out)
        assert (out["qval"][out["decoy"] == 0] < 0.01).sum() > 50


def test_specific_version_scores_without_retraining():
    mgr = _manager()
    mgr.fit_predict(_features(seed=1))
    mgr.fit_predict(_features(seed=3), version=0)
    assert len(mgr.classifier_store) == 1


def test_warm_start_from_previous_version():
    mgr = _manager()
    mgr.fit_predict(_features(seed=1))
    first = mgr.classifier_store[0]
    warm = mgr._get_classifier(-1)
    assert warm.fitted and warm is not first
    x = _matrix(_features(seed=4))
    np.testing.assert_allclose(warm.predict_proba(x), first.predict_proba(x), atol=1e-5)


def test_packaged_classifier_loads_for_default_features():
    assert FDR_FEATURE_COLUMNS == JAX_FDR_FEATURE_COLUMNS
    mgr = FDRManager(
        feature_columns=FDR_FEATURE_COLUMNS,
        classifier_base=BinaryClassifier(random_state=0, epochs=2, device="cpu"),
        random_state=0,
    )
    assert mgr.feature_hash() == "ea4b0fe1c1f77109"
    packaged = mgr._load_packaged_classifier()
    assert packaged is not None and packaged.fitted
    assert (packaged.epochs, packaged.random_state) == (2, 0)
    proba = packaged.predict_proba(np.random.default_rng(0).normal(size=(32, len(FDR_FEATURE_COLUMNS))).astype(np.float32))
    assert proba.shape == (32, 2) and np.isfinite(proba).all()
    assert mgr._get_classifier(-1).fitted  # a fresh manager starts from it


def test_channel_wise_strategy_fits_per_channel_qvalues():
    mgr = _manager()
    out = mgr.fit_predict(_features(n=2400, seed=5, channels=(0, 4)), decoy_strategy="precursor_channel_wise")
    assert set(np.unique(out["channel"]).tolist()) == {0, 4}
    assert (out["qval"] <= 1.0).all()
    # each channel's q-values are monotone in its own proba order
    for c in (0, 4):
        q = out["qval"][out["channel"] == c]
        assert (np.diff(q) >= 0).all()
    assert mgr.current_version == 0


def test_fallback_fit_does_not_store_unfitted_classifier():
    mgr = _manager()
    out = mgr.fit_predict(_features(n=80, seed=6))
    assert "qval" in out and out.attrs["fdr_estimator"] == "logistic"
    assert mgr.current_version == -1
    with pytest.raises(RuntimeError, match="no trained FDR classifier"):
        mgr.predict(_features(n=40, seed=7))


def test_unknown_strategy_raises():
    with pytest.raises(NotImplementedError):
        _manager().fit_predict(_features(), decoy_strategy="bogus")


def test_save_load_roundtrip(tmp_path):
    mgr = _manager(tmp_path)
    mgr.fit_predict(_features(seed=1))
    mgr.save()
    mgr2 = FDRManager(
        feature_columns=COLS,
        classifier_base=BinaryClassifier(random_state=0, epochs=4, device="cpu"),
        path=tmp_path / "fdr_manager.pkl",
        load_from_file=True,
    )
    assert mgr2.is_loaded_from_file and mgr2.current_version == 0
    x = _matrix(_features(seed=6))
    np.testing.assert_allclose(mgr2.classifier_store[0].predict_proba(x), mgr.classifier_store[0].predict_proba(x), atol=1e-5)
    scored = mgr2.predict(take(_features(seed=6), slice(0, 50)))
    assert scored["proba"].shape == (50,)


def test_xxh64_equals_xxhash():
    rng = np.random.default_rng(0)
    for _ in range(200):
        s = "".join(chr(c) for c in rng.integers(32, 0x3000, rng.integers(0, 80)))
        assert xxh64_hexdigest(s) == xxhash.xxh64_hexdigest(s), s
    key = "|".join(sorted(FDR_FEATURE_COLUMNS))
    assert xxh64_hexdigest(key) == xxhash.xxh64_hexdigest(key) == "ea4b0fe1c1f77109"
