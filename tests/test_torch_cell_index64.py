"""The peak store's 64-bit cell index: a store of 2**31 entries or more
(peaks and their ghosts, with the padding) gets an int64 ``cell_start``,
whose offsets never wrap; below that the index stays int32, byte for byte
the JAX package's (``test_torch_peakstore.py``).

No test here holds 2**31 peaks. The width is chosen from the stored total
against ``peakstore.INDEX32_LIMIT``, which the tests lower, so small worlds
take the int64 index; the C++ scatter is called on a cell-offset array past
2**31 with no peaks at all. Through the builders (1 and 8 threads),
``DiaData`` (its counts, the peak cycles, the fine and coarse views), every
plain extraction, and selection and scoring on the CPU, the int64 index
gives what the int32 index gives, exactly. The plain extractions from the
int64 index are also held against the JAX package's from its int32 index
(the 3D XIC's intensities, the 4D XICs and scan profiles), at the
tolerances of ``test_torch_xic.py``. The kernel's int64
instantiation runs on the card only: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` phase [18], which places a store behind 2**31 entries.
"""

import dataclasses

import numpy as np
import pytest
import torch

from alphadia_torch.ops.xic import extract_scan_profile, extract_xic, extract_xic_4d, extract_xic_packed
from alphadia_torch.ops.xic_cuda import extract_xic_cuda
from alphadia_torch.rawdata import DiaData
from alphadia_torch.rawdata import diadata, peakstore
from alphadia_torch.search.scoring import FEATURE_COLUMNS, CandidateScoring, ScoringConfig
from alphadia_torch.search.selection import CandidateSelection, SelectionConfig
from alphadia_torch.search.streaming import device_megabytes
from alphadia_torch.testing.offset_store import behind_filler
from alphadia_torch.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
from alphadia_tpu.ops.xic import extract_scan_profile as jax_scan_profile
from alphadia_tpu.ops.xic import extract_xic as jax_extract_xic
from alphadia_tpu.ops.xic import extract_xic_4d as jax_xic_4d
from alphadia_tpu.rawdata import DiaData as JaxDiaData

pytest_plugins = ("torch_port_plugin",)

STORE = ("peak_mz", "peak_intensity", "peak_is_ghost", "peak_scanbin")
TOL_PPM = 30.0
# test_torch_xic.py's tolerances against JAX's float32 prefix sums
TOL_INTENSITY = dict(rtol=1e-5, atol=1e-3)
TOL_MZ_DELTA = dict(rtol=1e-5, atol=1e-6)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def make_world(with_mobility):
    spectra, prec, frag = make_synthetic_dia(
        SyntheticConfig(n_peptides=100, n_windows=4, n_cycles=120, noise_peaks_per_spectrum=60, seed=21,
                        with_mobility=with_mobility)
    )
    prec, frag = add_synthetic_decoys(prec, frag)
    return spectra, prec, frag


@pytest.fixture(scope="module", params=[False, True], ids=["3d", "4d"])
def world(request):
    return make_world(request.param)


def build_both(spectra, **kw):
    """The world's DiaData with the int32 index and with the int64 one (the
    limit lowered to 1 while it builds)."""
    narrow = DiaData.from_spectra(spectra, n_scan_bins=8, **kw)
    saved = peakstore.INDEX32_LIMIT
    peakstore.INDEX32_LIMIT = 1
    try:
        wide = DiaData.from_spectra(spectra, n_scan_bins=8, **kw)
    finally:
        peakstore.INDEX32_LIMIT = saved
    assert narrow.cell_start.dtype == np.int32 and wide.cell_start.dtype == np.int64
    return narrow, wide


@pytest.fixture(scope="module")
def dias(world):
    return build_both(world[0])


@pytest.fixture(scope="module")
def jax_dia(world):
    return JaxDiaData.from_spectra(world[0], n_scan_bins=8)


@pytest.fixture(scope="module")
def world_4d():
    """The 4D world alone: its DiaData at both widths and JAX's."""
    spectra = make_world(True)[0]
    return (*build_both(spectra), JaxDiaData.from_spectra(spectra, n_scan_bins=8))


# ---------------------------------------------------------------------------
# the builders
# ---------------------------------------------------------------------------
def test_cell_index_dtype_at_the_limit():
    limit, pad = peakstore.INDEX32_LIMIT, peakstore.PAD
    assert limit == 2**31
    assert peakstore.cell_index_dtype(0) is np.int32
    assert peakstore.cell_index_dtype(limit - pad - 1) is np.int32
    assert peakstore.cell_index_dtype(limit - pad) is np.int64
    assert peakstore.cell_index_dtype(3 * limit) is np.int64


def store_args(spectra, monkeypatch):
    """The builder's arguments for a world, as ``DiaData`` passes them."""
    calls = []

    def record(*args, **kw):
        calls.append((args, kw))
        return peakstore.build_peak_store(*args, **kw)

    with monkeypatch.context() as m:
        m.setattr(diadata, "build_peak_store", record)
        DiaData.from_spectra(spectra, n_scan_bins=8)
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("threads", [1, 8])
def test_builders_take_int64_past_the_lowered_limit(world, threads, monkeypatch):
    """At the limit (total + PAD) the index is int64, one below it int32;
    either way the values are the int32 build's, in both builders."""
    args, kw = store_args(world[0], monkeypatch)
    kw["threads"] = threads
    narrow = peakstore.build_peak_store(*args, **kw)
    total = int(narrow.cell_start[-1, -1, -1])
    assert narrow.cell_start.dtype == np.int32 and total > len(args[0])  # ghosts stored
    monkeypatch.setattr(peakstore, "INDEX32_LIMIT", total + peakstore.PAD + 1)
    assert peakstore.build_peak_store(*args, **kw).cell_start.dtype == np.int32
    assert peakstore.build_peak_store_numpy(*args, scanbin=kw.get("scanbin")).cell_start.dtype == np.int32
    monkeypatch.setattr(peakstore, "INDEX32_LIMIT", total + peakstore.PAD)
    wide = peakstore.build_peak_store(*args, **kw)
    plain = peakstore.build_peak_store_numpy(*args, scanbin=kw.get("scanbin"))
    for got in (wide, plain):
        assert got.cell_start.dtype == np.int64 and got.cell_start.shape == narrow.cell_start.shape
        np.testing.assert_array_equal(got.cell_start, narrow.cell_start)
        for f in STORE:
            x, y = getattr(got, f), getattr(narrow, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def test_scatter_writes_offsets_past_2_31_unnarrowed():
    """The C++ scatter copies a cell-offset array with values past 2**31
    into an int64 index as it is (no peaks are needed: every spectrum is
    empty), and refuses to write it as int32 or at another width."""
    n_slots, n_bins, n_cycles = 2, 3, 4
    n_cells = n_slots * n_bins * n_cycles
    rng = np.random.default_rng(3)
    cell_off = np.concatenate([[2**31 - 7], 2**31 - 7 + np.cumsum(rng.integers(0, 2**30, n_cells))]).astype(np.int64)
    assert cell_off[-1] > 2**32  # past the int32 and the uint32 range
    spec_start = np.zeros(n_slots * n_cycles + 1, np.int64)
    lib = peakstore._library()
    empty = np.zeros(1, np.float32)

    def scatter(out, index_bytes, threads):
        grid = (spec_start.ctypes.data, n_slots * n_cycles, n_slots, n_cycles, 100.0, 1.0, n_bins, 0.25)
        return lib.peakstore_scatter(
            empty.ctypes.data, empty.ctypes.data, None, *grid, cell_off.ctypes.data,
            empty.ctypes.data, empty.ctypes.data, empty.ctypes.data, empty.ctypes.data,
            out.ctypes.data, index_bytes, threads,
        )

    rows = cell_off[:-1].reshape(n_slots * n_bins, n_cycles)
    want = np.concatenate([rows, np.append(rows[1:, 0], cell_off[-1])[:, None]], axis=1)
    for threads in (1, 4):
        out = np.zeros((n_slots, n_bins, n_cycles + 1), np.int64)
        assert scatter(out, 8, threads) == 0
        np.testing.assert_array_equal(out.reshape(n_slots * n_bins, -1), want)
        assert out.max() == cell_off[-1] and out.min() == 2**31 - 7
    narrow = np.zeros((n_slots, n_bins, n_cycles + 1), np.int32)
    for index_bytes in (4, 2, 0):
        assert scatter(narrow, index_bytes, 1) == -1
    assert not narrow.any()


# ---------------------------------------------------------------------------
# DiaData
# ---------------------------------------------------------------------------
def test_diadata_views_agree_between_widths(world, dias):
    narrow, wide = dias
    for f in STORE:
        assert getattr(narrow, f).tobytes() == getattr(wide, f).tobytes(), f
    assert wide.n_stored_peaks == narrow.n_stored_peaks > narrow.n_peaks
    np.testing.assert_array_equal(wide.peak_cycle(), narrow.peak_cycle())
    np.testing.assert_array_equal(wide.cycle_plane(), narrow.cycle_plane())
    for stride in (1, 2):
        (cs_n, crt_n, nc_n), (cs_w, crt_w, nc_w) = narrow.cell_index(stride), wide.cell_index(stride)
        assert cs_w.dtype == np.int64 and cs_n.dtype == np.int32 and nc_w == nc_n
        np.testing.assert_array_equal(cs_w, cs_n)
        np.testing.assert_array_equal(crt_w, crt_n)
        dev_n, dev_w = narrow.device_arrays(stride, "cpu"), wide.device_arrays(stride, "cpu")
        assert dev_w["cell_start"].dtype == torch.int64 and dev_n["cell_start"].dtype == torch.int32
        assert torch.equal(dev_w["cell_start"], dev_n["cell_start"].long())
        for a, b in zip(dev_w["peak_store"], dev_n["peak_store"]):
            assert torch.equal(a, b)
        assert device_megabytes(dev_w) - device_megabytes(dev_n) == pytest.approx(
            4 * dev_n["cell_start"].numel() / 1e6, rel=1e-12
        )
    # views made again after a free, and a copy's, keep the width
    wide.free_device()
    assert dataclasses.replace(wide, _device={}).device_arrays(2, "cpu")["cell_start"].dtype == torch.int64
    assert wide.device_arrays(1, "cpu")["cell_start"].dtype == torch.int64
    # the numpy builder makes the same choice
    plain_n, plain_w = build_both(world[0], use_native=False)
    np.testing.assert_array_equal(plain_w.cell_start, wide.cell_start)
    assert plain_n.cell_start.tobytes() == narrow.cell_start.tobytes()


def test_diadata_keeps_offsets_past_2_31():
    """A DiaData whose int64 index lies past 2**31 (a store behind 2**31
    entries that this test does not hold): its count and both views keep
    every offset, on the host and on the device."""
    n_slots, n_bins, n_cycles = 2, 3, 300
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 4, n_slots * n_bins * n_cycles)
    base = 2**31 + 11
    off = base + np.concatenate([[0], np.cumsum(counts)])
    rows = off[:-1].reshape(n_slots * n_bins, n_cycles)
    cs = np.concatenate([rows, np.append(rows[1:, 0], off[-1])[:, None]], axis=1).reshape(n_slots, n_bins, -1)
    dia = DiaData(
        cycle=np.full((1, n_slots, 1, 2), -1.0), rt_values=np.arange(n_cycles * n_slots, dtype=np.float32),
        cycle_rt=np.arange(n_cycles, dtype=np.float32) * 2, n_cycles=n_cycles, n_slots=n_slots, has_ms1=True,
        cell_start=cs.astype(np.int64), n_bins=n_bins,
    )
    assert dia.n_stored_peaks == off[-1] > 2**31
    for stride in (1, 2, 4):
        view, _, _ = dia.cell_index(stride)
        assert view.dtype == np.int64 and view.min() == base and view.max() == off[-1]
        # the fine view padded with each row's end, the coarse view strided
        np.testing.assert_array_equal(view, cs[:, :, np.minimum(np.arange(view.shape[2]) * stride, n_cycles)])


# ---------------------------------------------------------------------------
# the plain extractions
# ---------------------------------------------------------------------------
def queries(dia, dev, B, Q, W, stride, seed):
    """Queries on stored peaks (their slot and m/z, a window around their
    cycle), with masked queries and windows past either end."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, dia.n_stored_peaks, (B, Q))
    row = np.searchsorted(dia.cell_start[:, :, 0].reshape(-1), pick, side="right") - 1
    slot = (row // dia.n_bins).astype(np.int32)
    qmz = dia.peak_mz[pick].astype(np.float32)
    c0 = (dia.peak_cycle()[pick[:, 0]].astype(np.int64) // stride - rng.integers(0, W, B)).astype(np.int32)
    slot[0, :2] = -1
    c0[1] = -5
    c0[2] = dev["n_cycles"] - 2
    return slot, qmz, c0


def shifted(dev, shift):
    """The device view's store behind ``shift`` filler rows and its cell
    index moved by as much, in int64."""
    store, (first,) = behind_filler([dev["peak_store"]], shift)
    return store, dev["cell_start"].long() + first


XIC_CASES = {
    # name: (B, Q, W, slab, with_mz, mz_as_delta, stride, scan window)
    "a_intensity": (6, 9, 32, 128, False, False, 1, False),
    "a_slab_overflow": (6, 9, 32, 8, False, False, 1, False),
    "b_mz_delta": (6, 9, 32, 128, True, True, 1, False),
    "b_mz_absolute": (6, 9, 32, 128, True, False, 1, False),
    "c_scan_window": (6, 9, 32, 128, True, True, 1, True),
    "d_stride2": (6, 9, 32, 128, True, True, 2, False),
}


def random_mz_queries(dia, B, Q, n_cycles, seed):
    """Queries at random m/z in random slots, as ``test_torch_xic.py`` makes
    them for its comparison with JAX: slabs carry few matched peaks, so
    JAX's float32 prefix sums keep their low bits."""
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, dia.n_slots, (B, Q)).astype(np.int32)
    qmz = rng.uniform(250, 1200, (B, Q)).astype(np.float32)
    c0 = rng.integers(-4, n_cycles - 8, B).astype(np.int32)
    slot[0, -2:] = -1
    return slot, qmz, c0


@pytest.mark.parametrize("case", sorted(XIC_CASES))
def test_extract_xic_agrees_between_widths(dias, jax_dia, case):
    """``extract_xic_packed`` (the kernel's plain version) and the wrapper
    on the CPU give the same bits from the int32 index, from the int64
    index and from the int64 index over a store moved behind filler rows,
    on queries at stored peaks and at random m/z; on the latter, the
    intensities of JAX's ``extract_xic`` from its int32 index agree within
    tolerance."""
    B, Q, W, slab, with_mz, mz_as_delta, stride, scan = XIC_CASES[case]
    narrow, wide = dias
    dev_n, dev_w = narrow.device_arrays(stride, "cpu"), wide.device_arrays(stride, "cpu")
    kw = dict(
        n_cycles=dev_n["n_cycles"], n_bins=narrow.n_bins, bin_mz_min=narrow.bin_mz_min,
        bin_width=narrow.coarse_bin_width, slab=slab, window_len=W, with_mz=with_mz, mz_as_delta=mz_as_delta,
        cycle_stride=stride,
    )
    if scan:
        lo = np.random.default_rng(1).integers(0, 5, B).astype(np.int32)
        kw.update(scan_lo=t(lo), scan_hi=t(lo + 3))
    store_s, cs_s = shifted(dev_w, 1024)
    seed = sorted(XIC_CASES).index(case)
    for slot, qmz, c0 in (queries(narrow, dev_n, B, Q, W, stride, seed),
                          random_mz_queries(narrow, B, 96, narrow.n_cycles // stride, seed)):
        q = (t(slot), t(qmz), TOL_PPM, t(c0))
        ref = extract_xic_packed(dev_n["peak_store"], dev_n["cell_start"], *q, **kw)
        ref = ref if with_mz else (ref,)
        for store, cs in ((dev_w["peak_store"], dev_w["cell_start"]), (store_s, cs_s)):
            for fn in (extract_xic_packed, extract_xic_cuda):
                got = fn(store, cs, *q, **kw)
                got = got if with_mz else (got,)
                for g, r in zip(got, ref):
                    assert torch.equal(g, r)
        assert float(ref[0].sum()) > 0
    if scan:
        return  # the JAX package's extract_xic has no scan window (its 4D path: the next test)
    jdev = jax_dia.device_arrays(stride)
    jkw = {k: v for k, v in kw.items() if k != "cycle_stride"}
    want = jax_extract_xic(
        jdev["peak_mz"], jdev["peak_intensity"], jdev["cell_start"], slot, qmz, np.float32(TOL_PPM), c0, **jkw,
    )
    # the intensity plane: JAX's m/z plane comes from float32 prefix sums of
    # intensity x delta, whose lost low bits test_torch_xic.py's own world
    # and queries keep within its tolerance, these not always
    want = want[0] if with_mz else want
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL_INTENSITY)


@pytest.mark.parametrize("fn, stride", [("xic_4d", 1), ("xic_4d", 2), ("xic_4d_mz", 1), ("xic_4d_mz", 2),
                                        ("scan_profile", 1)])
def test_4d_plain_extractions_agree_between_widths(world_4d, fn, stride):
    """``extract_xic_4d`` and ``extract_scan_profile`` (the 4D path's plain
    extractions, on the card too) give the same bits from either index and
    from the moved store; JAX's agree within tolerance."""
    narrow, wide, jax_dia = world_4d
    dev_n, dev_w = narrow.device_arrays(stride, "cpu"), wide.device_arrays(stride, "cpu")
    B, Q, W = 5, 8, 32
    slot, qmz, c0 = queries(narrow, dev_n, B, Q, W, stride, 40 + stride)
    static = dict(
        n_cycles=dev_n["n_cycles"], n_bins=narrow.n_bins, bin_mz_min=narrow.bin_mz_min,
        bin_width=narrow.coarse_bin_width, n_scan_bins=narrow.n_scan_bins, slab=128,
    )
    store_s, cs_s = shifted(dev_w, 1024)
    views = [
        (dev_n["peak_store"], dev_n["cell_start"]), (dev_w["peak_store"], dev_w["cell_start"]), (store_s, cs_s),
    ]
    if fn == "scan_profile":
        hi = (c0 + np.random.default_rng(2).integers(1, 30, B)).astype(np.int32)
        outs = [
            (extract_scan_profile(s.packed[:, 0], s.packed[:, 1], s.scanbin, cs, t(slot), t(qmz), TOL_PPM, t(c0),
                                  t(hi), **static),)
            for s, cs in views
        ]
        jdev = jax_dia.device_arrays()
        want = (jax_scan_profile(jdev["peak_mz"], jdev["peak_intensity"], jdev["peak_scanbin"], jdev["cell_start"],
                                 slot, qmz, np.float32(TOL_PPM), c0, hi, **static),)
    else:
        with_mz = fn == "xic_4d_mz"
        outs = []
        for s, cs in views:
            o = extract_xic_4d(s.packed[:, 0], s.packed[:, 1], s.scanbin, cs, t(slot), t(qmz), TOL_PPM, t(c0),
                               window_len=W, with_mz=with_mz, **static)
            outs.append(o if with_mz else (o,))
        jdev = jax_dia.device_arrays(stride)
        want = jax_xic_4d(jdev["peak_mz"], jdev["peak_intensity"], jdev["peak_scanbin"], jdev["cell_start"],
                          slot, qmz, np.float32(TOL_PPM), c0, window_len=W, with_mz=with_mz, **static)
        want = want if with_mz else (want,)
    for other in outs[1:]:
        for g, r in zip(other, outs[0]):
            assert torch.equal(g, r)
    assert float(outs[0][0].sum()) > 0
    for g, w, tol in zip(outs[1], want, (TOL_INTENSITY, TOL_MZ_DELTA)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


# ---------------------------------------------------------------------------
# selection and scoring
# ---------------------------------------------------------------------------
def test_selection_and_scoring_agree_between_widths(world, dias):
    """The drivers on the CPU from the int64 DiaData: the same candidates
    (the wide window's coarse view too) and the same PSM features and
    fragments, bit for bit, as from the int32 one."""
    _, prec, frag = world
    out = []
    for dia in dias:
        cands = CandidateSelection(dia, prec, frag, SelectionConfig(rt_tolerance=60.0, candidate_count=3), device="cpu")()
        wide = CandidateSelection(dia, prec, frag, SelectionConfig(rt_tolerance=450.0, candidate_count=3), device="cpu")()
        psm, frags = CandidateScoring(dia, prec, frag, ScoringConfig(batch_size=512, collect_fragments=True),
                                      device="cpu")(cands)
        out.append((cands, wide, psm, frags))
    (c_n, w_n, p_n, f_n), (c_w, w_w, p_w, f_w) = out
    for a, b in ((c_n, c_w), (w_n, w_w), (f_n, f_w)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(c_n["precursor_idx"]) > 50 and len(p_n["precursor_idx"]) > 50
    assert p_n.keys() == p_w.keys()
    for k in p_n:
        np.testing.assert_array_equal(p_n[k], p_w[k], err_msg=k)
    assert all(np.isfinite(p_w[f]).all() for f in FEATURE_COLUMNS)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["int16", "uint8", "uint32", "float32", "float64", "numpy_int32"])
def test_wrapper_rejects_other_cell_index_types(dias, dtype):
    narrow, _ = dias
    dev = narrow.device_arrays(1, "cpu")
    cs = dev["cell_start"]
    other = cs.numpy() if dtype == "numpy_int32" else cs.to(getattr(torch, dtype))
    kw = dict(n_cycles=dev["n_cycles"], n_bins=narrow.n_bins, bin_mz_min=narrow.bin_mz_min,
              bin_width=narrow.coarse_bin_width, window_len=16)
    slot = torch.zeros((2, 3), dtype=torch.int32)
    args = (slot, torch.full((2, 3), 500.0), 10.0, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError, match="cell_start must be a torch.int32 or torch.int64 tensor"):
        extract_xic_cuda(dev["peak_store"], other, *args, **kw)
    for good in (cs, cs.long()):
        assert extract_xic_cuda(dev["peak_store"], good, *args, **kw).shape == (2, 3, 16)
