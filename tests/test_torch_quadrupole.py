"""The quadrupole transmission calibration, the port against the JAX
package: the observations harvested from a PSM frame, the
Levenberg-Marquardt fit, the model's prediction and the widened window
bounds, on a seeded frame of precursors in overlapping isolation windows
(float64 numpy on both sides, so held at rtol 1e-12)."""

import numpy as np
import pandas as pd
import pytest

from alphadia_torch.convert import frame_from_pandas
from alphadia_torch.search import quadrupole as port
from alphadia_tpu.search import quadrupole as jax_quad

pytest_plugins = ("torch_port_plugin",)

RTOL = 1e-12
SIGMA = (0.3, 0.4)
DELTA = (0.2, -0.1)
WIDTH, STEP = 25.0, 24.0  # windows overlap by 1 Th


def _psms(seed: int, n: int = 3000) -> pd.DataFrame:
    """Precursors in windows [400 + 24 k, 425 + 24 k): the per-window raw
    fragment sums of the one or two windows that hold each precursor, the
    planted transmission times its total with 3% noise; unused slots carry
    the JAX package's sentinel bounds (>= 1e6)."""
    rng = np.random.default_rng(seed)
    mz = rng.uniform(402.0, 998.0, n)
    k = np.floor((mz - 400.0) / STEP).astype(int)
    lo = np.full((n, 2), 1e7)
    hi = np.full((n, 2), 1e7)
    obs = np.zeros((n, 2))
    total = rng.lognormal(10, 1, n)
    for o, kk in enumerate((k, k - 1)):
        wlo = 400.0 + STEP * kk
        inside = (kk >= 0) & (mz >= wlo) & (mz < wlo + WIDTH)
        t = port.logistic_rectangle_np(wlo + DELTA[0], wlo + WIDTH + DELTA[1], SIGMA[0], SIGMA[1], mz)
        lo[inside, o], hi[inside, o] = wlo[inside], wlo[inside] + WIDTH
        obs[inside, o] = total[inside] * t[inside] * rng.normal(1.0, 0.03, int(inside.sum()))
    cols = {"mz_library": mz.astype(np.float32)}
    for o in range(2):
        cols[f"obs_intensity_{o}"] = obs[:, o].astype(np.float32)
        cols[f"obs_win_lo_{o}"] = lo[:, o].astype(np.float32)
        cols[f"obs_win_hi_{o}"] = hi[:, o].astype(np.float32)
    return pd.DataFrame(cols)


@pytest.mark.parametrize("seed", [0, 1])
def test_harvest_and_fit_match_jax(seed):
    df = _psms(seed)
    theirs = jax_quad.harvest_transmission(df)
    ours = port.harvest_transmission(frame_from_pandas(df))
    assert ours["n_multi"] == theirs["n_multi"] >= 100
    for k in ("mu1", "mu2", "x", "y"):
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)

    qj = jax_quad.QuadrupoleCalibration().fit(theirs["mu1"], theirs["mu2"], theirs["x"], theirs["y"])
    qp = port.QuadrupoleCalibration().fit(ours["mu1"], ours["mu2"], ours["x"], ours["y"])
    np.testing.assert_allclose(qp.sigma, qj.sigma, rtol=RTOL)
    np.testing.assert_allclose(qp.delta_mu, qj.delta_mu, rtol=RTOL, atol=1e-15)
    assert qp.n_samples == qj.n_samples and qp.fitted

    grid_lo = np.full(200, 400.0)
    mz = np.linspace(398.0, 427.0, 200)
    np.testing.assert_allclose(qp.predict(grid_lo, grid_lo + WIDTH, mz), qj.predict(grid_lo, grid_lo + WIDTH, mz), rtol=RTOL)
    # one MS1 slot (lo = -1) and four windows
    cycle = np.array([[[-1.0, -1.0], [400.0, 425.0], [424.0, 449.0], [448.0, 473.0], [472.0, 497.0]]])
    np.testing.assert_array_equal(qp.calibrated_cycle(cycle), qj.calibrated_cycle(cycle))


def test_harvest_without_observation_columns_is_none():
    df = _psms(0, n=50).drop(columns=["obs_intensity_1"])
    assert port.harvest_transmission(frame_from_pandas(df)) is None
    assert jax_quad.harvest_transmission(df) is None


def test_fit_from_start_values_matches_jax():
    """The fit started from a previous model, as each recalibration starts
    from the run's current one."""
    h = port.harvest_transmission(frame_from_pandas(_psms(2)))
    start = dict(sigma0=(0.5, 0.25), delta0=(-0.3, 0.4))
    sp, dp = port.fit_quadrupole_params(h["mu1"], h["mu2"], h["x"], h["y"], **start)
    sj, dj = jax_quad.fit_quadrupole_params(h["mu1"], h["mu2"], h["x"], h["y"], **start)
    np.testing.assert_allclose(sp, sj, rtol=RTOL)
    np.testing.assert_allclose(dp, dj, rtol=RTOL, atol=1e-15)
