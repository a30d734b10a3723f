"""Smoothing, peak finding and extents of the port against the JAX package.

Smoothing agrees within 1e-5. Peak indices, heights, ``keep`` masks and
extents are integers or selections of the inputs and must be exactly
equal, also on score maps with planted ties: ``jax.lax.top_k`` returns the
lower index first among equal values, which ``torch.topk`` does not
promise, so the port sorts stably instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphadia_torch.ops import features as tf
from alphadia_torch.ops import peaks as tp
from alphadia_torch.ops import smooth as ts
from alphadia_tpu.ops import features as jf
from alphadia_tpu.ops import peaks as jp
from alphadia_tpu.ops import smooth as js

pytest_plugins = ("torch_port_plugin",)


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tied_scores(seed, B=64, W=96):
    """Score maps with many equal-height peaks: small integer levels, and
    a planted pair of identical peaks per row."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 5, (B, W)).astype(np.float32)
    for b in range(B):
        for c in rng.choice(np.arange(4, W - 4), 2, replace=False):
            s[b, c - 2 : c + 3] = [1.0, 3.0, 7.0, 3.0, 1.0]
    return s


@pytest.mark.parametrize("sigma", [0.8, 2.5])
def test_smoothing_matches(sigma):
    rng = np.random.default_rng(1)
    prof = (rng.gamma(1.0, 1e4, (6, 5, 128)) * (rng.random((6, 5, 128)) < 0.4)).astype(np.float32)
    k = ts.gaussian_kernel_1d(30, sigma)
    np.testing.assert_array_equal(k, js.gaussian_kernel_1d(30, sigma))
    assert ts.rt_kernel_sigma(5.0, 0.5, 1.5) == js.rt_kernel_sigma(5.0, 0.5, 1.5)
    got = ts.convolve_profiles(t(prof), t(k), kernel_size=30)
    ref = js.convolve_profiles(prof, k, kernel_size=30)
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-5, atol=1e-5 * float(np.abs(prof).max()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_peaks_with_ties_is_exact(seed):
    s = tied_scores(seed)
    idx, score, valid = tp.find_peaks_profile(t(s), top_n=4)
    jidx, jscore, jvalid = jp.find_peaks_profile(s, top_n=4)
    np.testing.assert_array_equal(n(idx), n(jidx))
    np.testing.assert_array_equal(n(score), n(jscore))
    np.testing.assert_array_equal(n(valid), n(jvalid))
    # the planted ties are there, and come out lower index first
    top = n(score)
    tie = top[:, 0] == top[:, 1]
    assert tie.sum() >= 32
    assert (n(idx)[tie, 0] < n(idx)[tie, 1]).all()


def test_top_k_stable_orders_ties_by_index():
    x = t(np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0, 3.0] * 40], np.float32))
    values, idx = tp.top_k_stable(x, 5)
    assert n(idx).tolist() == [[1, 2, 4, 6, 8]]
    assert n(values).tolist() == [[3.0] * 5]


@pytest.mark.parametrize("tol", [4, 6])  # stencil peaks lie >= 4 apart
def test_suppress_close_peaks_is_exact(tol):
    s = tied_scores(3)
    jidx, _, jvalid = jp.find_peaks_profile(s, top_n=5)
    keep = tp.suppress_close_peaks(t(jidx), t(jvalid), tol)
    ref = jp.suppress_close_peaks(jidx, jvalid, tol)
    np.testing.assert_array_equal(n(keep), n(ref))
    assert (n(keep) != n(jvalid)).any()  # some peaks were suppressed


@pytest.mark.parametrize("min_size,max_size", [(3, 15), (1, 8)])
def test_symmetric_limits_are_exact(min_size, max_size):
    rng = np.random.default_rng(4)
    s = np.cumsum(rng.normal(0, 1, (64, 96)), axis=1).astype(np.float32)
    s[:, ::7] = s[:, 1::7][:, : s[:, ::7].shape[1]]  # equal neighbours
    centre = rng.integers(-2, 98, (64, 3)).astype(np.int32)
    kw = dict(f=0.99, center_fraction=0.5, min_size=min_size, max_size=max_size)
    start, stop = tp.symmetric_limits_profile(t(s), t(np.maximum(centre, 0)), **kw)
    jstart, jstop = jp.symmetric_limits_profile(s, np.maximum(centre, 0), **kw)
    np.testing.assert_array_equal(n(start), n(jstart))
    np.testing.assert_array_equal(n(stop), n(jstop))


def test_join_overlapping_is_exact():
    rng = np.random.default_rng(5)
    start = rng.integers(0, 60, (128, 3)).astype(np.int32)
    stop = (start + rng.integers(1, 20, (128, 3))).astype(np.int32)
    keep = rng.random((128, 3)) < 0.8
    got = tp.join_overlapping_1d(t(start), t(stop), t(keep), 0.6)
    ref = jp.join_overlapping_1d(jnp.asarray(start), jnp.asarray(stop), jnp.asarray(keep), 0.6)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(n(g), n(r))
    assert (n(got[2]) != keep).any()  # some candidates were merged


def test_masked_median_averages_the_middle_pair():
    """``jnp.nanmedian`` averages the two middle values of an even count;
    ``torch.nanmedian`` returns the lower one."""
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (12, 40)).astype(np.float32)
    mask = rng.random((12, 40)) < 0.5
    mask[:, 0] = mask[:, 1] = True
    mask[:4, 2:] = False  # even count: exactly two
    mask[4, :] = False  # nothing masked in: 0
    got = tf.masked_median(t(x), t(mask), dim=0)
    ref = jf.masked_median(x, mask, axis=0)
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-6, atol=1e-7)
    row = tf.masked_median(t(x[:4, :1].T), t(np.ones((1, 4), bool)), dim=1)
    assert float(row[0]) == pytest.approx(float(np.median(x[:4, 0])), rel=1e-6)


def test_ref_top3_ion_correlation_with_ties():
    """Stable argsort + flip: equal intensities order like numpy's stable
    ascending sort reversed."""
    rng = np.random.default_rng(7)
    B, K = 64, 12
    vals = rng.normal(0, 1, (B, K)).astype(np.float32)
    mz = rng.uniform(200, 1200, (B, K)).astype(np.float32)
    inten = rng.integers(1, 4, (B, K)).astype(np.float32)  # many ties
    mask = rng.random((B, K)) < 0.85
    is_b = rng.random((B, K)) < 0.5
    got = tf.ref_top3_ion_correlation(t(vals), t(mz), t(inten), t(mask), t(is_b))
    ref = jf.ref_top3_ion_correlation(vals, mz, inten, mask, is_b)
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-6, atol=1e-7)
    top = tf.topk_mean_by(t(vals), t(inten), t(mask), 3)
    np.testing.assert_allclose(n(top), n(jf.topk_mean_by(vals, inten, mask, 3)), rtol=1e-6, atol=1e-7)
