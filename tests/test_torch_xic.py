"""The plain XIC extraction of the port against the JAX XLA path, for every
way the main path calls the kernel: (a) intensity only, (b) with the m/z
plane, (c) the scan-window crop, (d) the coarse cycle view
(``cycle_stride`` > 1). The Pallas kernel itself (interpret mode) is held
against the port in ``test_torch_xic_pallas*.py``.

Tolerances: those of the JAX package's own Pallas-vs-XLA test (rtol 1e-5,
atol 1e-3 for intensities and 1e-2 for absolute m/z), and atol 1e-6 Da for
the m/z plane as a delta from the query centre, whose values lie within
+-tol_ppm * m/z, so that a delta plane of zeros fails. The XLA path takes
differences of float32 prefix sums, which lose the low bits of a small
cell behind a large one; the queries here sit at random m/z, as in that
test, so slabs carry few matched peaks. The port sums in float64.
"""

import numpy as np
import pytest
import torch

from alphadia_torch.convert import diadata_from_jax
from alphadia_torch.ops.xic import extract_xic
from alphadia_torch.ops.xic_cuda import extract_xic_cuda
from alphadia_tpu.ops.xic import extract_xic as jax_extract_xic
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.testing.synthetic import SyntheticConfig, make_synthetic_dia

pytest_plugins = ("torch_port_plugin",)
TOL_PPM = 50.0  # wide enough for random m/z to meet noise peaks


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def world():
    # 24 windows + MS1 = 25 slots: the store shape that once zeroed XICs
    # on XLA:CPU at W=128, B>=4
    spectra, _, _ = make_synthetic_dia(
        SyntheticConfig(n_peptides=60, n_windows=24, n_cycles=70, noise_peaks_per_spectrum=300, seed=4)
    )
    jd = JaxDiaData.from_spectra(spectra, use_native=False)
    return jd, diadata_from_jax(jd)


@pytest.fixture(scope="module")
def dense_world():
    """20-Th coarse bins: a row holds dozens of peaks per cycle, so slabs
    overflow ``slab``."""
    spectra, _, _ = make_synthetic_dia(
        SyntheticConfig(n_peptides=40, n_windows=4, n_cycles=40, noise_peaks_per_spectrum=200, seed=9)
    )
    jd = JaxDiaData.from_spectra(spectra, coarse_bin_width=20.0, use_native=False)
    return jd, diadata_from_jax(jd)


def random_queries(dia, B, Q, n_cycles, seed):
    """Queries at random m/z in random MS2 slots, with masked queries, an
    MS1 query, an m/z below the first bin, and windows that start before
    cycle 0 or run past the last cycle."""
    rng = np.random.default_rng(seed)
    slot = rng.integers(1, dia.n_slots, (B, Q)).astype(np.int32)
    qmz = rng.uniform(250, 1200, (B, Q)).astype(np.float32)
    c0 = rng.integers(-4, n_cycles - 8, B).astype(np.int32)
    slot[0, -2:] = -1
    slot[-1, 0] = 0
    qmz[1, 0] = 5.0
    c0[0] = -7
    c0[-1] = n_cycles - 3
    return slot, qmz, c0


def xic_kw(dia, dev, W, slab, with_mz=False, mz_as_delta=False):
    return dict(
        n_cycles=dev["n_cycles"], n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min,
        bin_width=dia.coarse_bin_width, slab=slab, window_len=W,
        with_mz=with_mz, mz_as_delta=mz_as_delta,
    )


def planes(x):
    return x if isinstance(x, tuple) else (x,)


def tolerances(with_mz, mz_as_delta):
    mz = dict(rtol=1e-5, atol=1e-6 if mz_as_delta else 1e-2)
    return [dict(rtol=1e-5, atol=1e-3)] + ([mz] if with_mz else [])


CASES = {
    # name: (B, Q, W, slab, with_mz, mz_as_delta, stride)
    "a_intensity": (6, 9, 24, 128, False, False, 1),
    "b_mz_delta": (6, 9, 24, 128, True, True, 1),
    "b_mz_absolute": (6, 9, 24, 128, True, False, 1),
    "a_w128_25slots": (4, 12, 128, 256, False, False, 1),
    "d_stride2": (6, 9, 32, 128, False, False, 2),
    "d_stride4": (4, 6, 16, 256, True, True, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_xla(world, case):
    jd, td = world
    B, Q, W, slab, with_mz, mz_as_delta, stride = CASES[case]
    jdev = jd.device_arrays(stride)
    tdev = td.device_arrays(stride, "cpu")
    slot, qmz, c0 = random_queries(td, B, Q, tdev["n_cycles"], sorted(CASES).index(case))
    kw = xic_kw(td, tdev, W, slab, with_mz, mz_as_delta)
    ref = jax_extract_xic(
        jdev["peak_mz"], jdev["peak_intensity"], jdev["cell_start"],
        slot, qmz, np.float32(TOL_PPM), c0, **kw,
    )
    got = extract_xic(
        tdev["peak_mz"], tdev["peak_intensity"], tdev["cell_start"],
        t(slot), t(qmz), TOL_PPM, t(c0), **kw,
    )
    # on CPU tensors the kernel's wrapper runs the plain version
    via_wrapper = extract_xic_cuda(
        tdev["peak_packed"], tdev["cell_start"], t(slot), t(qmz), TOL_PPM, t(c0),
        cycle_stride=stride, **kw,
    )
    for r, g, v, tol in zip(planes(ref), planes(got), planes(via_wrapper), tolerances(with_mz, mz_as_delta)):
        np.testing.assert_allclose(n(g), n(r), **tol)
        np.testing.assert_array_equal(n(v), n(g))
    assert float(planes(got)[0].sum()) > 0
    # masked queries give zeros
    assert float(planes(got)[0][0, -2:].abs().sum()) == 0.0


def test_slab_truncation_drops_the_same_peaks(dense_world):
    """Peaks past ``slab`` from the slab start are dropped, by both."""
    jd, td = dense_world
    dev = td.device_arrays(1, "cpu")
    slot, qmz, c0 = random_queries(td, 5, 7, dev["n_cycles"], 11)
    kw = xic_kw(td, dev, 32, 8, with_mz=True, mz_as_delta=True)
    args = (dev["peak_mz"], dev["peak_intensity"], dev["cell_start"], t(slot), t(qmz), 20.0, t(c0))
    full = extract_xic(*args, **{**kw, "slab": 4096})
    cut = extract_xic(*args, **kw)
    assert float(cut[0].sum()) < float(full[0].sum())
    jdev = jd.device_arrays()
    ref = jax_extract_xic(
        jdev["peak_mz"], jdev["peak_intensity"], jdev["cell_start"], slot, qmz,
        np.float32(20.0), c0, **kw,
    )
    for r, g, tol in zip(ref, cut, tolerances(True, True)):
        np.testing.assert_allclose(n(g), n(r), **tol)


def test_out_of_range_indices_are_clamped(world):
    """``jnp.take(..., mode="clip")`` becomes an explicit clamp: a window
    far before cycle 0 or past the end, a slot past the last, and an m/z
    outside every bin read the clipped cell and give zeros, not an error."""
    jd, td = world
    dev = td.device_arrays(1, "cpu")
    jdev = jd.device_arrays()
    B, Q, W = 4, 3, 16
    slot = np.array([[1, 2, 3]] * B, np.int32)
    slot[3] = td.n_slots + 5  # past the last slot: clamped to it
    qmz = np.array([[5.0, 600.0, 1e5]] * B, np.float32)
    c0 = np.array([-200, -W, dev["n_cycles"] + 50, 10], np.int32)
    kw = xic_kw(td, dev, W, 64)
    got = extract_xic(
        dev["peak_mz"], dev["peak_intensity"], dev["cell_start"], t(slot), t(qmz), 20.0, t(c0), **kw
    )
    ref = jax_extract_xic(
        jdev["peak_mz"], jdev["peak_intensity"], jdev["cell_start"], slot, qmz, np.float32(20.0), c0, **kw
    )
    np.testing.assert_allclose(n(got), n(ref), rtol=1e-5, atol=1e-3)
    assert float(got[:3].abs().sum()) == 0.0


def test_cycle_index_w_means_cycle_c0_plus_w(world):
    """A window shifted left by k cycles shows the same XIC k places later,
    also where the shifted window starts before cycle 0."""
    _, td = world
    dev = td.device_arrays(1, "cpu")
    slot, qmz, _ = random_queries(td, 4, 6, dev["n_cycles"], 5)
    kw = xic_kw(td, dev, 32, 256)
    args = (dev["peak_mz"], dev["peak_intensity"], dev["cell_start"], t(slot), t(qmz), 20.0)
    for base in (20, 3):
        c0 = np.full(4, base, np.int32)
        a = extract_xic(*args, t(c0), **kw)
        b = extract_xic(*args, t(c0 - 5), **kw)
        torch.testing.assert_close(b[:, :, 5:], a[:, :, :-5])
        if base - 5 < 0:
            assert float(b[:, :, : 5 - base].abs().sum()) == 0.0


@pytest.mark.parametrize("with_mz", [False, True])
def test_c_scan_window_matches_xla(with_mz):
    spectra, _, _ = make_synthetic_dia(
        SyntheticConfig(
            n_peptides=30, n_windows=4, n_cycles=50, noise_peaks_per_spectrum=30,
            with_mobility=True,
        )
    )
    jd = JaxDiaData.from_spectra(spectra, n_scan_bins=8, use_native=False)
    td = diadata_from_jax(jd)
    rng = np.random.default_rng(3)
    B, Q, W = 5, 7, 16
    slot = rng.integers(1, td.n_slots, (B, Q)).astype(np.int32)
    qmz = rng.uniform(250, 1200, (B, Q)).astype(np.float32)
    c0 = rng.integers(0, td.n_cycles - 8, B).astype(np.int32)
    scan_lo = rng.integers(0, 4, B).astype(np.int32)
    scan_hi = (scan_lo + rng.integers(2, 5, B)).astype(np.int32)
    jdev = jd.device_arrays()
    tdev = td.device_arrays(1, "cpu")
    kw = xic_kw(td, tdev, W, 128, with_mz)
    ref = jax_extract_xic(
        jdev["peak_mz"], jdev["peak_intensity"], jdev["cell_start"], slot, qmz,
        np.float32(50.0), c0, peak_scanbin=jdev["peak_scanbin"],
        scan_lo=scan_lo, scan_hi=scan_hi, **kw,
    )
    got = extract_xic_cuda(
        tdev["peak_packed"], tdev["cell_start"], t(slot), t(qmz), 50.0, t(c0),
        scan_lo=t(scan_lo), scan_hi=t(scan_hi), **kw,
    )
    for r, g, tol in zip(planes(ref), planes(got), tolerances(with_mz, False)):
        np.testing.assert_allclose(n(g), n(r), **tol)
    full = extract_xic_cuda(
        tdev["peak_packed"], tdev["cell_start"], t(slot), t(qmz), 50.0, t(c0), **kw
    )
    assert 0 < float(planes(got)[0].sum()) < float(planes(full)[0].sum())


def test_wrapper_rejects_bad_inputs(world):
    _, td = world
    dev = td.device_arrays(1, "cpu")
    kw = dict(n_cycles=dev["n_cycles"], n_bins=td.n_bins, bin_mz_min=td.bin_mz_min,
              bin_width=td.coarse_bin_width, window_len=16)
    slot = torch.zeros((2, 3), dtype=torch.int32)
    qmz = torch.full((2, 3), 500.0)
    c0 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        extract_xic_cuda(dev["peak_packed"], dev["cell_start"], slot, qmz, 10.0, c0, cycle_stride=3, **kw)
    with pytest.raises(ValueError, match="go together"):
        extract_xic_cuda(dev["peak_packed"], dev["cell_start"], slot, qmz, 10.0, c0, scan_lo=c0, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        extract_xic_cuda(dev["peak_packed"].to("meta"), dev["cell_start"], slot, qmz, 10.0, c0, **kw)
