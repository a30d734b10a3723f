"""Calibration: the port against the JAX package (LOESS, the estimator, the
manager, all float64 numpy in both) and the numpy regressions against
scikit-learn's."""

import numpy as np
import pandas as pd
import pytest
from sklearn.linear_model import LinearRegression as SkLinearRegression
from sklearn.pipeline import Pipeline
from sklearn.preprocessing import PolynomialFeatures

from alphadia_torch.calibration import CalibrationEstimator, LinearRegression, LOESSRegression, construct_polynomial_regression
from alphadia_torch.convert import frame_from_pandas
from alphadia_torch.workflow.managers.calibration_manager import CalibrationManager
from alphadia_tpu.calibration import CalibrationEstimator as JaxCalibrationEstimator
from alphadia_tpu.calibration import LOESSRegression as JaxLOESSRegression
from alphadia_tpu.workflow.managers.calibration_manager import CalibrationManager as JaxCalibrationManager

pytest_plugins = ("torch_port_plugin",)

RTOL = 1e-10


def _data(n, seed=0, clustered=False):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(300, 20, n // 2), rng.uniform(0, 900, n - n // 2)]) if clustered else rng.uniform(0, 900, n)
    y = x + 10 * np.sin(x / 150) + rng.normal(0, 2, n)
    return x, y


@pytest.mark.parametrize(
    "n,kw,clustered",
    [
        (2000, dict(n_kernels=6), False),  # density placement
        (2000, dict(n_kernels=2), True),
        (2000, dict(n_kernels=6, uniform=True), False),  # uniform placement
        (400, dict(n_kernels=6, uniform=True), True),  # uniform, too few in a kernel: density fallback
        (11, dict(n_kernels=6), False),  # fewer kernels for small data
        (2, dict(n_kernels=6), False),  # a lower polynomial degree too
        (7, dict(n_kernels=2, polynomial_degree=3), False),  # no outlier trim below 8 points
    ],
    ids=["density", "density_clustered", "uniform", "uniform_density_fallback", "small_data", "two_points", "seven_points"],
)
def test_loess_matches_jax(n, kw, clustered):
    x, y = _data(n, seed=n, clustered=clustered)
    ours, theirs = LOESSRegression(**kw).fit(x, y), JaxLOESSRegression(**kw).fit(x, y)
    for attr in ("centers", "halfwidths", "beta"):
        np.testing.assert_allclose(getattr(ours, attr), getattr(theirs, attr), rtol=RTOL, atol=0)
    assert (ours.n_kernels, ours.polynomial_degree) == (theirs.n_kernels, theirs.polynomial_degree)
    assert ours.get_params() == theirs.get_params()
    grid = np.linspace(-100, 1000, 301)  # extrapolation at both ends
    np.testing.assert_allclose(ours.predict(grid), theirs.predict(grid), rtol=RTOL, atol=1e-12)


def test_loess_refits_restore_the_configured_complexity():
    ours, theirs = LOESSRegression(n_kernels=6), JaxLOESSRegression(n_kernels=6)
    for n in (5, 3000, 9, 800):
        x, y = _data(n, seed=n)
        ours.fit(x, y)
        theirs.fit(x, y)
        assert ours.n_kernels == theirs.n_kernels
        np.testing.assert_allclose(ours.beta, theirs.beta, rtol=RTOL, atol=0)
        np.testing.assert_allclose(ours.predict(x), theirs.predict(x), rtol=RTOL, atol=0)
    assert ours.n_kernels == 6


def _psm_frame(n=1500, seed=4, mobility=False):
    rng = np.random.default_rng(seed)
    mz = rng.uniform(400, 1000, n)
    rt = rng.uniform(0, 1200, n)
    df = {
        "mz_library": mz.astype(np.float32),
        "mz_observed": (mz * (1 + (4 + 0.002 * (mz - 700) + rng.normal(0, 1.5, n)) * 1e-6)).astype(np.float32),
        "rt_library": rt.astype(np.float32),
        "rt_observed": (rt + 30 * np.sin(rt / 400) + rng.normal(0, 4, n)).astype(np.float32),
    }
    if mobility:
        mob = rng.uniform(0.6, 1.4, n)
        df["mobility_library"] = mob.astype(np.float32)
        df["mobility_observed"] = (mob + 0.01 + rng.normal(0, 0.005, n)).astype(np.float32)
    return pd.DataFrame(df)


@pytest.mark.parametrize("transform", [None, 1e6])
def test_estimator_deviation_ci_and_metrics_match_jax(transform):
    df = _psm_frame()
    cols = (["mz_library"], ["mz_observed"], ["mz_calibrated"])
    ours = CalibrationEstimator("mz", LOESSRegression(n_kernels=2), *cols, transform_deviation=transform)
    theirs = JaxCalibrationEstimator("mz", JaxLOESSRegression(n_kernels=2), *cols, transform_deviation=transform)
    frame = frame_from_pandas(df)
    np.testing.assert_allclose(ours.fit(frame), theirs.fit(df), rtol=RTOL)
    np.testing.assert_allclose(ours.calc_deviation(frame), theirs.calc_deviation(df), rtol=RTOL, atol=1e-12)
    for ci in (0.5, 0.95, 0.99):
        assert ours.ci(frame, ci) == pytest.approx(theirs.ci(df, ci), rel=RTOL)
    assert ours.metrics == pytest.approx(theirs.metrics, rel=RTOL)
    ours.predict(frame)
    theirs.predict(df)
    assert frame["mz_calibrated"].dtype == np.float32
    np.testing.assert_array_equal(frame["mz_calibrated"], df["mz_calibrated"].to_numpy())
    with pytest.raises(ValueError):
        ours.ci(frame, 1.0)
    unfitted = CalibrationEstimator("rt", LOESSRegression(), ["rt_library"], ["rt_observed"], ["rt_calibrated"])
    assert unfitted.ci(frame) == 0.0 and unfitted.predict(frame) is None
    assert unfitted.fit({"rt_library": frame["rt_library"]}).tolist() == [0.0] and not unfitted.is_fitted


@pytest.mark.parametrize("mobility", [False, True], ids=["3d", "4d"])
def test_manager_fit_and_predict_match_jax(mobility, tmp_path):
    df = _psm_frame(mobility=mobility)
    frag = pd.DataFrame({
        "mz_library": np.linspace(200, 1400, 3000).astype(np.float32),
        "mz_observed": (np.linspace(200, 1400, 3000) * (1 + 4e-6)).astype(np.float32),
    })
    ours = CalibrationManager(tmp_path / "cm.pkl", has_ms1=True, has_mobility=mobility)
    theirs = JaxCalibrationManager(has_ms1=True, has_mobility=mobility)
    frame, frag_frame = frame_from_pandas(df), frame_from_pandas(frag)
    for group, (a, b) in (("precursor", (frame, df)), ("fragment", (frag_frame, frag))):
        ours.fit_predict(a, group)
        theirs.fit_predict(b, group)
    assert sorted(ours.groups["precursor"]) == sorted(theirs.groups["precursor"])
    assert ours.is_fitted and theirs.is_fitted
    for col in ("mz_calibrated", "rt_calibrated") + (("mobility_calibrated",) if mobility else ()):
        np.testing.assert_array_equal(frame[col], df[col].to_numpy())
    np.testing.assert_array_equal(frag_frame["mz_calibrated"], frag["mz_calibrated"].to_numpy())
    # too few rows: nothing is fitted
    small = CalibrationManager(has_ms1=True, has_mobility=mobility)
    small.fit({k: v[:1] for k, v in frame.items()}, "precursor")
    assert not small.is_fitted
    # the pickle round trip
    ours.save()
    again = CalibrationManager(tmp_path / "cm.pkl", load_from_file=True, has_ms1=True, has_mobility=mobility)
    assert again.is_loaded_from_file and again.is_fitted
    x = df["rt_library"].to_numpy(np.float64)
    np.testing.assert_array_equal(again.get_estimator("precursor", "rt").function.predict(x), ours.get_estimator("precursor", "rt").function.predict(x))


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("n_features", [1, 3])
def test_linear_regression_matches_sklearn(fit_intercept, n_features):
    rng = np.random.default_rng(n_features)
    X = rng.normal(5, 2, (500, n_features))
    y = X @ rng.normal(0, 1, n_features) + 3 + rng.normal(0, 0.1, 500)
    ours, theirs = LinearRegression(fit_intercept=fit_intercept).fit(X, y), SkLinearRegression(fit_intercept=fit_intercept).fit(X, y)
    np.testing.assert_allclose(ours.coef_, theirs.coef_, rtol=1e-8)
    np.testing.assert_allclose(ours.intercept_, theirs.intercept_, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(ours.predict(X), theirs.predict(X), rtol=1e-8)
    if n_features == 1:  # the estimator hands a 1D column
        np.testing.assert_allclose(ours.fit(X[:, 0], y).predict(X[:, 0]), theirs.predict(X), rtol=1e-8)


@pytest.mark.parametrize("degree,n_features", [(1, 1), (2, 1), (3, 1), (2, 2)])
def test_polynomial_regression_matches_sklearn(degree, n_features):
    rng = np.random.default_rng(degree)
    X = rng.uniform(-2, 2, (400, n_features))
    y = np.sin(X).sum(axis=1) + rng.normal(0, 0.05, 400)
    ours = construct_polynomial_regression(degree).fit(X, y)
    theirs = Pipeline(
        [("poly", PolynomialFeatures(degree=degree, include_bias=True)), ("linear", SkLinearRegression(fit_intercept=False))]
    ).fit(X, y)
    np.testing.assert_allclose(ours.linear.coef_, theirs.named_steps["linear"].coef_, rtol=1e-8, atol=1e-12)
    grid = rng.uniform(-2.5, 2.5, (100, n_features))
    np.testing.assert_allclose(ours.predict(grid), theirs.predict(grid), rtol=1e-8, atol=1e-12)
