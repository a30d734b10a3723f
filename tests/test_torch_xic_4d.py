"""The port's plain 4D extractions, ``extract_xic_4d`` (intensity [B, Q, S,
W], with and without the m/z delta plane) and ``extract_scan_profile``
([B, Q, S] over a cycle window), against the JAX functions on a 4D world.

Queries sit on stored peaks (so cells carry signal) in their own slot, with
masked queries (slot -1), windows that start before cycle 0 or run past the
last cycle, slabs cut short of their cells (slab 4), and the stride-2
coarse ``cell_start`` that 4D selection reads for wide windows.

Two references:

- a direct float64 sum written here, which places each slab peak by its own
  cycle and scan bin: the port within rtol 1e-6 (intensities, profiles) and
  atol 1e-8 Da (m/z delta plane);
- the JAX functions: rtol 1e-4 with atol 1e-3 for intensities, atol 1e-6 Da
  for the m/z delta plane (whose values lie within +-tol_ppm * m/z). JAX
  takes differences of float32 prefix sums over S one-hot channels, which
  lose up to ~5e-5 relative on a small cell behind an elution apex in the
  same channel (the 3D extraction's known loss, ROADMAP section 3); the port
  sums in float64.
"""

import numpy as np
import pytest
import torch

from alphadia_torch.convert import diadata_from_jax
from alphadia_torch.ops.xic import extract_scan_profile, extract_xic, extract_xic_4d
from alphadia_tpu.ops.xic import extract_scan_profile as jax_scan_profile
from alphadia_tpu.ops.xic import extract_xic_4d as jax_xic_4d
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.testing.synthetic import SyntheticConfig, make_synthetic_dia

pytest_plugins = ("torch_port_plugin",)
TOL_PPM = 15.0
TOL_INTENSITY = dict(rtol=1e-4, atol=1e-3)
TOL_MZ_DELTA = dict(rtol=1e-5, atol=1e-6)
TOL_DIRECT = dict(rtol=1e-6, atol=1e-4)
TOL_DIRECT_MZ = dict(rtol=0, atol=1e-8)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def world():
    spectra, _, _ = make_synthetic_dia(
        SyntheticConfig(
            n_peptides=120, n_windows=6, n_cycles=120, noise_peaks_per_spectrum=60,
            with_mobility=True, seed=13,
        )
    )
    jd = JaxDiaData.from_spectra(spectra, n_scan_bins=8, use_native=False)
    td = diadata_from_jax(jd)
    assert td.has_mobility and td.n_scan_bins == 8
    return jd, td


def peak_queries(dia, B, Q, W, stride, n_cycles, seed):
    """Queries on intense stored peaks (elution profiles rather than
    noise): the slot of the peak's row, its m/z, a window that holds its
    cycle; then the edge cases."""
    rng = np.random.default_rng(seed)
    inten = dia.peak_intensity[: dia.n_stored_peaks]
    pick = rng.choice(np.nonzero(inten > np.quantile(inten, 0.9))[0], (B, Q))
    row = np.searchsorted(dia.cell_start[:, :, 0].reshape(-1), pick, side="right") - 1
    slot = (row // dia.n_bins).astype(np.int32)
    qmz = dia.peak_mz[pick].astype(np.float32)
    cyc = dia.peak_cycle()[pick[:, 0]].astype(np.int64) // stride
    c0 = (cyc - rng.integers(0, W, B)).astype(np.int32)
    slot[0, :2] = -1  # masked queries
    c0[1] = -5  # starts before cycle 0
    c0[2] = n_cycles - 2  # runs past the last cycle
    return slot, qmz, c0


def direct_4d(td, dev, slot, qmz, c0, W, slab, stride, with_mz):
    """f32[B, Q, S, W] (and the m/z delta plane): each query reads at most
    ``slab`` peaks from its window's first cell, and every peak inside the
    ppm window adds to the (scan bin, cycle // stride) cell it belongs to,
    summed in float64."""
    packed, cyc, scanbin = td.packed_store(), td.peak_cycle(), td.scanbin_plane()
    cs = dev["cell_start"].numpy()
    n_cyc = dev["n_cycles"]
    B, Q = slot.shape
    S = td.n_scan_bins
    inten = np.zeros((B, Q, S, W))
    dmz = np.zeros((B, Q, S, W))
    tol = np.float32(TOL_PPM) * np.float32(1e-6)
    lo_f, hi_f = np.float32(1) - tol, np.float32(1) + tol
    for b in range(B):
        for q in range(Q):
            if slot[b, q] < 0:
                continue
            lo, hi = qmz[b, q] * lo_f, qmz[b, q] * hi_f
            qc = (lo + hi) * np.float32(0.5)
            bin_ = int(np.clip(np.floor((qmz[b, q] - np.float32(td.bin_mz_min)) / np.float32(td.coarse_bin_width)), 0, td.n_bins - 1))
            row = cs[slot[b, q], bin_]
            r0 = row[np.clip(c0[b], 0, n_cyc)]
            n = int(np.clip(row[np.clip(c0[b] + W, 0, n_cyc)] - r0, 0, slab))
            p = packed[r0 : r0 + n]
            w = cyc[r0 : r0 + n].astype(np.int64) // stride - c0[b]
            ok = (p[:, 0] >= lo) & (p[:, 0] <= hi) & (w >= 0) & (w < W)
            at = (scanbin[r0 : r0 + n][ok].astype(np.int64), w[ok])
            np.add.at(inten[b, q], at, p[ok, 1].astype(np.float64))
            np.add.at(dmz[b, q], at, (p[ok, 1] * (p[ok, 0] - qc)).astype(np.float64))
    dmz = np.where(inten > 0, dmz / np.maximum(inten, 1e-12), 0.0)
    return (inten.astype(np.float32), dmz) if with_mz else inten.astype(np.float32)


def static_kw(td, dev, slab):
    return dict(
        n_cycles=dev["n_cycles"], n_bins=td.n_bins, bin_mz_min=td.bin_mz_min,
        bin_width=td.coarse_bin_width, n_scan_bins=td.n_scan_bins, slab=slab,
    )


CASES = {
    # name: (B, Q, W, slab, with_mz, stride)
    "intensity": (6, 10, 32, 256, False, 1),
    "mz_delta": (6, 10, 32, 256, True, 1),
    "slab_overflow": (5, 8, 32, 4, True, 1),
    "stride2": (6, 10, 32, 256, True, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_xic_4d_matches_jax(world, case):
    jd, td = world
    B, Q, W, slab, with_mz, stride = CASES[case]
    jdev = jd.device_arrays(stride)
    dev = td.device_arrays(stride, "cpu")
    slot, qmz, c0 = peak_queries(td, B, Q, W, stride, dev["n_cycles"], sorted(CASES).index(case))
    kw = dict(static_kw(td, dev, slab), window_len=W, with_mz=with_mz)
    ref = jax_xic_4d(
        jdev["peak_mz"], jdev["peak_intensity"], jdev["peak_scanbin"], jdev["cell_start"],
        slot, qmz, np.float32(TOL_PPM), c0, **kw,
    )
    got = extract_xic_4d(
        dev["peak_store"].packed[:, 0], dev["peak_store"].packed[:, 1], dev["peak_store"].scanbin, dev["cell_start"],
        t(slot), t(qmz), TOL_PPM, t(c0), **kw,
    )
    ref = ref if with_mz else (ref,)
    got = got if with_mz else (got,)
    assert got[0].shape == (B, Q, td.n_scan_bins, W)
    direct = direct_4d(td, dev, slot, qmz, c0, W, slab, stride, with_mz)
    direct = direct if with_mz else (direct,)
    for g, r, d, tol, tol_d in zip(got, ref, direct, (TOL_INTENSITY, TOL_MZ_DELTA), (TOL_DIRECT, TOL_DIRECT_MZ)):
        np.testing.assert_allclose(g.numpy(), d, **tol_d)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)
    inten = got[0]
    assert float(inten[0, :2].abs().sum()) == 0.0  # masked queries
    # signal spreads over several scan bins, and the delta plane is not zero
    assert int((inten.sum(dim=(0, 1, 3)) > 0).sum()) >= 4
    if with_mz:
        assert float(got[1].abs().max()) > 1e-4


def test_slab_overflow_drops_peaks(world):
    """A slab of 4 peaks drops the peaks of the window that lie beyond it."""
    _, td = world
    dev = td.device_arrays(1, "cpu")
    slot, qmz, c0 = peak_queries(td, 5, 8, 32, 1, dev["n_cycles"], 2)
    args = (dev["peak_store"].packed[:, 0], dev["peak_store"].packed[:, 1], dev["peak_store"].scanbin, dev["cell_start"],
            t(slot), t(qmz), TOL_PPM, t(c0))
    kw = static_kw(td, dev, 4)
    cut = extract_xic_4d(*args, **kw, window_len=32)
    full = extract_xic_4d(*args, **{**kw, "slab": 4096}, window_len=32)
    assert 0 < float(cut.sum()) < float(full.sum())


@pytest.mark.parametrize("stride", [1, 2])
def test_4d_collapses_to_the_3d_xic(world, stride):
    """Summed over scan bins, the 4D XIC is the port's 3D XIC."""
    _, td = world
    dev = td.device_arrays(stride, "cpu")
    slot, qmz, c0 = peak_queries(td, 4, 12, 32, stride, dev["n_cycles"], 5)
    kw = static_kw(td, dev, 256)
    S = kw.pop("n_scan_bins")
    x4 = extract_xic_4d(
        dev["peak_store"].packed[:, 0], dev["peak_store"].packed[:, 1], dev["peak_store"].scanbin, dev["cell_start"],
        t(slot), t(qmz), TOL_PPM, t(c0), n_scan_bins=S, window_len=32, **kw,
    )
    x3 = extract_xic(
        dev["peak_store"].packed[:, 0], dev["peak_store"].packed[:, 1], dev["cell_start"], t(slot), t(qmz), TOL_PPM, t(c0),
        window_len=32, **kw,
    )
    torch.testing.assert_close(x4.sum(dim=2), x3, rtol=1e-5, atol=1e-3)
    assert float(x3.sum()) > 0


@pytest.mark.parametrize("slab", [256, 4])
def test_scan_profile_matches_jax(world, slab):
    jd, td = world
    jdev = jd.device_arrays()
    dev = td.device_arrays(1, "cpu")
    B, Q = 6, 10
    slot, qmz, c0 = peak_queries(td, B, Q, 24, 1, dev["n_cycles"], 7 + slab)
    rng = np.random.default_rng(slab)
    lo = c0.copy()
    hi = (lo + rng.integers(3, 30, B)).astype(np.int32)
    lo[3], hi[3] = -8, 6  # window starts before cycle 0
    lo[4], hi[4] = dev["n_cycles"] - 4, dev["n_cycles"] + 9  # and runs past the end
    lo[5], hi[5] = 40, 40  # empty window
    kw = static_kw(td, dev, slab)
    ref = jax_scan_profile(
        jdev["peak_mz"], jdev["peak_intensity"], jdev["peak_scanbin"], jdev["cell_start"],
        slot, qmz, np.float32(TOL_PPM), lo, hi, **kw,
    )
    got = extract_scan_profile(
        dev["peak_store"].packed[:, 0], dev["peak_store"].packed[:, 1], dev["peak_store"].scanbin, dev["cell_start"],
        t(slot), t(qmz), TOL_PPM, t(lo), t(hi), **kw,
    )
    assert got.shape == (B, Q, td.n_scan_bins)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL_INTENSITY)
    # the profile is the 4D XIC of the window summed over its cycles
    W = int((hi - lo).max())
    x4 = extract_xic_4d(
        dev["peak_store"].packed[:, 0], dev["peak_store"].packed[:, 1], dev["peak_store"].scanbin, dev["cell_start"],
        t(slot), t(qmz), TOL_PPM, t(lo), window_len=W, **kw,
    )
    inside = torch.arange(W)[None, :] < t(hi - lo)[:, None]  # [B, W]
    if slab == 256:
        torch.testing.assert_close(got, (x4 * inside[:, None, None, :]).sum(-1), **TOL_DIRECT)
    assert float(got.sum()) > 0
    assert float(got[0, :2].abs().sum()) == 0.0 and float(got[5].abs().sum()) == 0.0
