"""The port's 2D peak functions (the 4D selection's peak finding, extents,
suppression and merging) against the JAX functions on identical score maps
made from a seed with numpy.

Integer outputs are held exactly equal; peak scores too (they are values of
the map). The maps are smooth bumps on noise, and maps quantised to steps of
1/8, which are full of ties: ``jax.lax.top_k`` over the flattened (scan,
cycle) map puts the lower flat index first among equal scores, and so does
the port's stable sort.

``symmetric_limits_2d`` compares window sums of the map against each other.
The port adds a window's terms one by one in index order; JAX contracts with
a 0/1 mask in a float32 dot product. Where the two sums differed in their
last bit an extent could move, so its test holds the share of identical
extents at 1.0 on these maps and reports any miss.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphadia_torch.ops import peaks as ours
from alphadia_tpu.ops import peaks as theirs

pytest_plugins = ("torch_port_plugin",)


def score_maps(kind, B=64, S=8, W=48, seed=0):
    rng = np.random.default_rng(seed)
    s = np.arange(S)[None, :, None]
    w = np.arange(W)[None, None, :]
    maps = 0.3 * rng.standard_normal((B, S, W))
    for _ in range(3):  # three bumps of random height, place and width
        a = rng.uniform(0.5, 4.0, (B, 1, 1))
        s0 = rng.uniform(-1, S, (B, 1, 1))
        w0 = rng.uniform(0, W, (B, 1, 1))
        ws = rng.uniform(0.8, 2.0, (B, 1, 1))
        ww = rng.uniform(2.0, 6.0, (B, 1, 1))
        maps = maps + a * np.exp(-0.5 * (((s - s0) / ws) ** 2 + ((w - w0) / ww) ** 2))
    if kind == "ties":
        maps = np.round(maps * 8) / 8
    return maps.astype(np.float32)


KINDS = ["smooth", "ties"]


@pytest.fixture(scope="module", params=KINDS)
def peaks(request):
    score = score_maps(request.param, seed=KINDS.index(request.param))
    ref = theirs.find_peaks_profile_2d(jnp.asarray(score), top_n=3)
    got = ours.find_peaks_profile_2d(torch.from_numpy(score), top_n=3)
    return request.param, score, [np.asarray(r) for r in ref], [g.numpy() for g in got]


def test_find_peaks_2d(peaks):
    kind, score, ref, got = peaks
    names = ("scan_idx", "cycle_idx", "peak_score", "valid")
    for name, r, g in zip(names, ref, got):
        np.testing.assert_array_equal(g, r, err_msg=name)
    valid = got[3]
    # most rows have a peak, and some rows fewer than three
    assert valid[:, 0].mean() > 0.5 and not valid.all()
    if kind == "ties":
        # equal scores among a row's returned peaks: ties are really met
        assert any(len(set(row[v])) < v.sum() for row, v in zip(got[2], valid))
    # apexes in the outermost scan bins pass through the ramp padding
    assert {0, score.shape[1] - 1} & set(got[0][valid].tolist())


@pytest.mark.parametrize("sizes", [(3, 15, 2, 6), (1, 8, 1, 4)], ids=["fine", "coarse"])
def test_symmetric_limits_2d(peaks, sizes):
    _, score, ref_peaks, got_peaks = peaks
    min_rt, max_rt, min_mob, max_mob = sizes
    kw = dict(
        f_mobility=0.99, f_rt=0.99, center_fraction=0.5, min_size_mobility=min_mob,
        max_size_mobility=max_mob, min_size_rt=min_rt, max_size_rt=max_rt,
    )
    scan_c, cyc_c = np.maximum(ref_peaks[0], 0), np.maximum(ref_peaks[1], 0)
    ref = theirs.symmetric_limits_2d(jnp.asarray(score), jnp.asarray(scan_c), jnp.asarray(cyc_c), **kw)
    got = ours.symmetric_limits_2d(
        torch.from_numpy(score), torch.from_numpy(scan_c), torch.from_numpy(cyc_c), **kw
    )
    same = np.stack([g.numpy() == np.asarray(r) for g, r in zip(got, ref)])
    assert same.mean() == 1.0, f"identical extents: {same.mean():.4f}"
    for g in got:
        assert g.dtype == torch.int32
    # extents grow past their minimum somewhere
    assert (got[1].numpy() - got[0].numpy() > 2 * min_mob + 1).any()
    assert (got[3].numpy() - got[2].numpy() > 2 * min_rt + 1).any()


def test_limits_on_profiles():
    rng = np.random.default_rng(3)
    B, C, L = 40, 3, 24
    x = np.arange(L)[None, None, :]
    centre = rng.integers(0, L, (B, C))
    prof = (
        rng.uniform(1, 5, (B, C, 1)) * np.exp(-0.5 * ((x - centre[..., None]) / rng.uniform(1, 4, (B, C, 1))) ** 2)
        + 0.05 * rng.standard_normal((B, C, L))
    ).astype(np.float32)
    for f, cf, lo, hi in ((0.99, 0.5, 2, 6), (0.9, 0.2, 1, 12)):
        ref = theirs._limits_on_profiles(jnp.asarray(prof), jnp.asarray(centre), f, cf, lo, hi)
        got = ours._limits_on_profiles(torch.from_numpy(prof), torch.from_numpy(centre), f, cf, lo, hi)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def candidate_slots(seed, B=200, C=3):
    rng = np.random.default_rng(seed)
    scan = rng.integers(0, 8, (B, C)).astype(np.int32)
    cyc = rng.integers(0, 20, (B, C)).astype(np.int32)
    valid = rng.random((B, C)) < 0.85
    return scan, cyc, valid


@pytest.mark.parametrize("tol", [(3, 3), (1, 4), (0, 0)])
def test_suppress_close_peaks_2d(tol):
    scan, cyc, valid = candidate_slots(sum(tol))
    ref = theirs.suppress_close_peaks_2d(jnp.asarray(scan), jnp.asarray(cyc), jnp.asarray(valid), *tol)
    got = ours.suppress_close_peaks_2d(torch.from_numpy(scan), torch.from_numpy(cyc), torch.from_numpy(valid), *tol)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if tol != (0, 0):
        assert got.sum() < valid.sum()


@pytest.mark.parametrize("overlap", [(0.01, 0.6), (0.5, 0.2)])
def test_join_overlapping_2d(overlap):
    rng = np.random.default_rng(int(overlap[1] * 10))
    scan, cyc, keep = candidate_slots(5)
    args = (
        np.maximum(scan - rng.integers(1, 3, scan.shape), 0).astype(np.int32),
        (scan + rng.integers(1, 3, scan.shape)).astype(np.int32),
        np.maximum(cyc - rng.integers(1, 6, cyc.shape), 0).astype(np.int32),
        (cyc + rng.integers(1, 6, cyc.shape)).astype(np.int32),
        keep,
    )
    ref = theirs.join_overlapping_2d(*(jnp.asarray(a) for a in args), *overlap)
    got = ours.join_overlapping_2d(*(torch.from_numpy(a) for a in args), *overlap)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[4].sum() < keep.sum()  # some candidates merged
    # the inputs are left as they were
    np.testing.assert_array_equal(args[4], keep)
