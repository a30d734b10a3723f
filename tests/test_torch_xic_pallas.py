"""The port's XIC extraction against the Pallas kernel it replaces, run in
interpret mode as the JAX package's own tests run it: (a) intensity only,
with slab overflow, and (b) the m/z plane as a delta.

The queries sit on stored peaks, so most carry signal. The Pallas kernel,
like the CUDA kernel, sums each cell directly. Tolerances: rtol 1e-5, atol
1e-3 for intensities and 1e-6 Da for the m/z plane, a delta from the query
centre whose values lie within +-tol_ppm * m/z. Each case compiles the Pallas
kernel once (tens of seconds here), so this file keeps to two.
"""

import numpy as np
import pytest
import torch

from alphadia_torch.convert import diadata_from_jax
from alphadia_torch.ops.xic_cuda import extract_xic_cuda
from alphadia_tpu.ops.xic_pallas import extract_xic_pallas
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.testing.synthetic import SyntheticConfig, make_synthetic_dia

pytest_plugins = ("torch_port_plugin",)


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def peak_queries(dia, B, Q, W, seed):
    """Queries centred on stored peaks, plus masked queries, an m/z below
    the first bin, and windows that start before cycle 0 or run past the
    last cycle."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, dia.n_stored_peaks, (B, Q))
    row = np.searchsorted(dia.cell_start[:, :, 0].reshape(-1), pick, side="right") - 1
    slot = (row // dia.n_bins).astype(np.int32)
    qmz = (dia.peak_mz[pick] * (1 + rng.normal(0, 3e-6, (B, Q)))).astype(np.float32)
    cyc = dia.peak_cycle()[pick[:, 0]].astype(np.int64)
    c0 = (cyc - rng.integers(0, W, B)).astype(np.int32)
    slot[0, -2:] = -1
    qmz[1, 0] = 5.0
    c0[0] = -7
    c0[-1] = dia.n_cycles - 3
    return slot, qmz, c0


def compare(jd, td, *, B, Q, W, slab, with_mz, stride=1, seed=0, scan=None):
    jdev = jd.device_arrays(stride)
    tdev = td.device_arrays(stride, "cpu")
    slot, qmz, c0 = peak_queries(td, B, Q, W * stride, seed)
    c0 = (c0 // stride).astype(np.int32)
    kw = dict(
        n_cycles=tdev["n_cycles"], n_bins=td.n_bins, bin_mz_min=td.bin_mz_min,
        bin_width=td.coarse_bin_width, slab=slab, window_len=W,
        with_mz=with_mz, mz_as_delta=True, cycle_stride=stride,
    )
    scan_np = scan(B) if scan else {}
    ref = extract_xic_pallas(
        jdev["peak_packed"], jdev["cell_start"], slot, qmz, np.float32(20.0), c0,
        interpret=True, **kw, **scan_np,
    )
    got = extract_xic_cuda(
        tdev["peak_store"], tdev["cell_start"], t(slot), t(qmz), 20.0, t(c0),
        **kw, **{k: t(v) for k, v in scan_np.items()},
    )
    ref = ref if with_mz else (ref,)
    got = got if with_mz else (got,)
    tols = [dict(rtol=1e-5, atol=1e-3), dict(rtol=1e-5, atol=1e-6)]
    for r, g, tol in zip(ref, got, tols):
        np.testing.assert_allclose(n(g), n(r), **tol)
    assert float(got[0].sum()) > 0
    return got


@pytest.fixture(scope="module")
def world():
    spectra, _, _ = make_synthetic_dia(
        SyntheticConfig(n_peptides=60, n_windows=6, n_cycles=60, noise_peaks_per_spectrum=200, seed=4)
    )
    # 10-Th coarse bins: rows hold enough peaks for slabs to overflow
    jd = JaxDiaData.from_spectra(spectra, coarse_bin_width=10.0, use_native=False)
    return jd, diadata_from_jax(jd)


def test_a_intensity_with_slab_overflow(world):
    jd, td = world
    got = compare(jd, td, B=6, Q=9, W=24, slab=16, with_mz=False, seed=1)
    # some slabs were cut: a longer slab sees more
    tdev = td.device_arrays(1, "cpu")
    slot, qmz, c0 = peak_queries(td, 6, 9, 24, 1)
    long = extract_xic_cuda(
        tdev["peak_store"], tdev["cell_start"], t(slot), t(qmz), 20.0, t(c0),
        n_cycles=tdev["n_cycles"], n_bins=td.n_bins, bin_mz_min=td.bin_mz_min,
        bin_width=td.coarse_bin_width, slab=4096, window_len=24,
    )
    assert float(got[0].sum()) < float(long.sum())


def test_b_mz_delta(world):
    jd, td = world
    compare(jd, td, B=6, Q=9, W=24, slab=128, with_mz=True, seed=2)
