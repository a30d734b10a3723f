"""The port's C++ peak-store builder (``csrc/peakstore.cpp`` through
``rawdata/peakstore.build_peak_store``) against its plain numpy version and
the JAX package's native builder (``alphadia_tpu.native``), every array equal
byte for byte: on the 3D and 4D synthetic worlds through ``DiaData``, and
called directly on peaks at bin edges (both ghosts), outside the binned
range, in empty spectra and in one spectrum, on 1 and on several threads.
Without a compiler, or when the build fails, ``DiaData`` raises: there is
no fallback to the numpy builder."""

import numpy as np
import pytest

from alphadia_torch.rawdata import DiaData
from alphadia_torch.rawdata import diadata, peakstore
from alphadia_torch.testing.synthetic import SyntheticConfig, make_synthetic_dia
from alphadia_torch.utils import cxx
from alphadia_tpu.native import build_peak_store_native
from alphadia_tpu.rawdata import DiaData as JaxDiaData

pytest_plugins = ("torch_port_plugin",)

STORE = ("peak_mz", "peak_intensity", "peak_is_ghost", "peak_scanbin", "cell_start")
THREADS = (1, 3, 8)


def assert_same(a, b):
    for f in STORE:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, (f, x.dtype, y.dtype, x.shape, y.shape)
        assert x.tobytes() == y.tobytes(), f


def jax_native(mz, intensity, spec_start, n_slots, n_cycles, lo, width, n_bins, ghost, scanbin=None):
    """JAX's native builder, finished as JAX's ``DiaData`` finishes it."""
    out = build_peak_store_native(mz, intensity, spec_start, n_slots, n_cycles, lo, width, n_bins, ghost, scanbin)
    assert out is not None, "the JAX package's native builder did not load"
    out_mz, out_int, out_ghost, cell_off, out_sb = out
    rows = cell_off[:-1].reshape(n_slots * n_bins, n_cycles)
    ends = np.append(rows[1:, 0], cell_off[-1])
    pad = peakstore.PAD
    return peakstore.PeakStoreArrays(
        np.concatenate([out_mz, np.full(pad, np.float32(np.inf))]),
        np.concatenate([out_int, np.zeros(pad, np.float32)]),
        np.concatenate([out_ghost, np.zeros(pad, bool)]),
        np.concatenate([out_sb, np.zeros(pad, np.int32)]) if out_sb is not None else np.zeros(len(out_mz) + pad, np.int32),
        np.concatenate([rows, ends[:, None]], axis=1).reshape(n_slots, n_bins, n_cycles + 1).astype(np.int32),
    )


# ---------------------------------------------------------------------------
# the synthetic worlds through DiaData
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[False, True], ids=["3d", "4d"])
def world(request):
    spectra, _, _ = make_synthetic_dia(
        SyntheticConfig(n_peptides=120, n_windows=4, n_cycles=80, noise_peaks_per_spectrum=60, seed=11,
                        with_mobility=request.param)
    )
    return spectra


def test_diadata_builds_with_the_cpp_builder_by_default(world):
    ours = DiaData.from_spectra(world, n_scan_bins=8)
    plain = DiaData.from_spectra(world, n_scan_bins=8, use_native=False)
    theirs = JaxDiaData.from_spectra(world, n_scan_bins=8)
    assert ours.use_native and not plain.use_native and theirs.use_native
    assert_same(ours, plain)
    assert_same(ours, theirs)
    assert ours.n_stored_peaks > len(world.mz)  # ghosts were stored


@pytest.mark.parametrize("threads", THREADS)
def test_world_equal_at_every_thread_count(world, threads, monkeypatch):
    calls = []

    def at_threads(*args, **kw):
        calls.append((args, kw))
        return peakstore.build_peak_store(*args, **kw, threads=threads)

    monkeypatch.setattr(diadata, "build_peak_store", at_threads)
    dia = DiaData.from_spectra(world, n_scan_bins=8)
    assert len(calls) == 1
    assert_same(dia, DiaData.from_spectra(world, n_scan_bins=8, use_native=False))
    args, kw = calls[0]
    assert_same(dia, jax_native(*args, **kw))


# ---------------------------------------------------------------------------
# direct calls: bin edges, the range's ends, empty spectra
# ---------------------------------------------------------------------------
def direct_case(name, seed=0):
    """(mz, intensity, spec_start, n_slots, n_cycles, lo, width, n_bins,
    ghost, scanbin) of a case; m/z ascending within each spectrum."""
    rng = np.random.default_rng(seed)
    lo, width, n_bins, ghost = 100.0, 1.0, 10, 0.25
    n_slots, n_cycles = 3, 5
    counts = rng.integers(0, 40, n_slots * n_cycles)
    if name == "edges":  # width below twice the ghost: a peak may have both ghosts
        width, n_bins = 0.4, 25
        edges = lo + width * rng.integers(1, n_bins, 200)
        pool = np.concatenate([edges + d for d in (-0.2501, -0.25, -0.1, -1e-4, 0.0, 1e-4, 0.1, 0.25, 0.2501)])
    elif name == "outside":  # below the first bin and above the last, where JAX's builder stays in bounds
        pool = np.concatenate([rng.uniform(98.9, 100.0, 60), rng.uniform(100, 110, 60), rng.uniform(110.0, 110.24, 60)])
    elif name == "empty_spectra":
        counts[rng.random(len(counts)) < 0.5] = 0
        counts[0] = counts[-1] = 0
        pool = rng.uniform(100, 110, 200)
    elif name == "one_spectrum":
        n_slots = n_cycles = 1
        counts = np.array([150])
        pool = rng.uniform(99.5, 110.2, 400)
    elif name == "no_peaks":
        counts[:] = 0
        pool = np.zeros(1)
    else:
        raise ValueError(name)
    mz = []
    for c in counts:
        mz.append(np.sort(rng.choice(pool, c).astype(np.float32)))
    mz = np.concatenate(mz).astype(np.float32)
    spec_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    intensity = rng.uniform(1, 1e4, len(mz)).astype(np.float32)
    scanbin = rng.integers(0, 8, len(mz)).astype(np.int32)
    return mz, intensity, spec_start, n_slots, n_cycles, lo, width, n_bins, ghost, scanbin


CASES = ("edges", "outside", "empty_spectra", "one_spectrum", "no_peaks")


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("name", CASES)
def test_direct_cases_equal_numpy_and_jax(name, threads):
    *args, scanbin = direct_case(name)
    for sb in (None, scanbin):
        got = peakstore.build_peak_store(*args, scanbin=sb, threads=threads)
        assert_same(got, peakstore.build_peak_store_numpy(*args, scanbin=sb))
        assert_same(got, jax_native(*args, scanbin=sb))
    if name == "edges":  # a peak with both ghosts
        mz, lo, width, ghost = args[0].astype(np.float64), args[5], args[6], args[8]
        bins = ((mz - lo) / width).astype(np.int64)
        up, dn = ((mz + ghost - lo) / width).astype(np.int64), ((mz - ghost - lo) / width).astype(np.int64)
        assert ((up != bins) & (dn != bins) & (bins > 0) & (bins < args[7] - 1)).any()


def test_values_outside_any_bin_are_clipped_as_numpy_clips_them():
    """NaN, infinities and values far outside the range: the numpy builder's
    bins (JAX's native builder writes out of bounds for some of these)."""
    mz, intensity, spec_start, *grid, scanbin = direct_case("empty_spectra", seed=4)
    rng = np.random.default_rng(4)
    odd = np.array([np.nan, -np.inf, np.inf, -1e30, 1e30, 0.0, 50.0, 99.0, 111.0, 500.0, 9.3e18], np.float32)
    mz = mz.copy()
    mz[rng.choice(len(mz), 40, replace=False)] = rng.choice(odd, 40)
    for threads in (1, 4):
        got = peakstore.build_peak_store(mz, intensity, spec_start, *grid, scanbin=scanbin, threads=threads)
        assert_same(got, peakstore.build_peak_store_numpy(mz, intensity, spec_start, *grid, scanbin=scanbin))


def test_default_thread_count_gives_the_same_arrays():
    *args, scanbin = direct_case("edges", seed=2)
    assert_same(peakstore.build_peak_store(*args, scanbin=scanbin),
                peakstore.build_peak_store(*args, scanbin=scanbin, threads=1))


@pytest.mark.parametrize(
    "spec_start, n_slots, n_cycles",
    [([1, 3], 1, 1), ([0, 3, 2, 4], 3, 1), ([0, 1, 2, 3, 4], 1, 3), ([0, 4], 0, 1)],
    ids=["not_from_0", "falling", "too_many_spectra", "no_slots"],
)
def test_bad_grid_raises(spec_start, n_slots, n_cycles):
    mz = np.linspace(100, 104, 4, dtype=np.float32)
    for build in (peakstore.build_peak_store, peakstore.build_peak_store_numpy):
        with pytest.raises(ValueError):
            build(mz, mz, np.array(spec_start), n_slots, n_cycles, 100.0, 1.0, 5, 0.25)


@pytest.mark.parametrize("short", ["intensity", "scanbin"])
def test_arrays_of_other_lengths_raise(short):
    mz, intensity, spec_start, *grid, scanbin = direct_case("edges")
    arrays = {"intensity": intensity, "scanbin": scanbin}
    arrays[short] = arrays[short][:-1]
    for build in (peakstore.build_peak_store, peakstore.build_peak_store_numpy):
        with pytest.raises(ValueError, match="one entry a peak"):
            build(mz, arrays["intensity"], spec_start, *grid, scanbin=arrays["scanbin"])


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------
def test_no_compiler_raises(world, tmp_path, monkeypatch):
    monkeypatch.setenv("ALPHADIA_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(peakstore, "_lib", None)
    monkeypatch.setattr(cxx.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        DiaData.from_spectra(world)
    assert DiaData.from_spectra(world, use_native=False).n_stored_peaks > 0  # the plain version asked for


def test_failed_build_raises(world, tmp_path, monkeypatch):
    monkeypatch.setenv("ALPHADIA_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(peakstore, "_lib", None)
    monkeypatch.setattr(peakstore, "CXX_FLAGS", [*peakstore.CXX_FLAGS, "-fno-such-option-anywhere"])
    with pytest.raises(RuntimeError, match="building the peak-store builder failed"):
        DiaData.from_spectra(world)
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


def test_builds_once_per_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setenv("ALPHADIA_TORCH_BUILD_DIR", str(tmp_path))
    lib = peakstore.build()
    assert lib.parent == tmp_path and lib.name.startswith("libpeakstore_") and lib.suffix == ".so"
    assert peakstore.build() == lib
