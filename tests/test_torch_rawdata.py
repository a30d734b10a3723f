"""The port's synthetic world and peak store equal the JAX package's."""

import numpy as np
import pytest
import torch

from alphadia_torch.rawdata import DiaData
from alphadia_torch.testing.synthetic import (
    SyntheticConfig,
    add_synthetic_decoys,
    make_synthetic_dia,
)
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.testing import synthetic as jax_synthetic

pytest_plugins = ("torch_port_plugin",)

_SPECTRA_FIELDS = (
    "rt", "ms_level", "isolation_lower_mz", "isolation_upper_mz",
    "peak_start_idx", "peak_stop_idx", "mz", "intensity", "mobility",
)


def _worlds(seed, **kw):
    cfg = dict(n_peptides=40, n_windows=4, n_cycles=60, noise_peaks_per_spectrum=20, seed=seed, **kw)
    ours = make_synthetic_dia(SyntheticConfig(**cfg))
    theirs = jax_synthetic.make_synthetic_dia(jax_synthetic.SyntheticConfig(**cfg))
    return ours, theirs


def _assert_frame_equal(ours: dict, theirs):
    # the port drops the xxhash columns, which nothing on the path reads
    expected = [c for c in theirs.columns if c not in ("mod_seq_hash", "mod_seq_charge_hash")]
    assert sorted(ours) == sorted(expected)
    for c in expected:
        a, b = ours[c], theirs[c].to_numpy()
        if b.dtype == object:
            assert [str(x) for x in a] == [str(x) for x in b], c
        else:
            assert a.dtype == b.dtype, (c, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=c)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("with_mobility", [False, True])
def test_synthetic_world_is_identical(seed, with_mobility):
    (sp, prec, frag), (jsp, jprec, jfrag) = _worlds(seed, with_mobility=with_mobility)
    for f in _SPECTRA_FIELDS:
        a, b = getattr(sp, f), getattr(jsp, f)
        if b is None:
            assert a is None, f
        else:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    _assert_frame_equal(prec, jprec)
    _assert_frame_equal(frag, jfrag)


@pytest.mark.parametrize("seed", [0, 7])
def test_decoys_are_identical(seed):
    (_, prec, frag), (_, jprec, jfrag) = _worlds(seed)
    for multiplier in (1, 2):
        p, f = add_synthetic_decoys(prec, frag, multiplier=multiplier)
        jp, jf = jax_synthetic.add_synthetic_decoys(jprec, jfrag, multiplier=multiplier)
        _assert_frame_equal(p, jp)
        _assert_frame_equal(f, jf)


@pytest.fixture(scope="module", params=[False, True], ids=["3d", "4d"])
def stores(request):
    (sp, _, _), _ = _worlds(3, with_mobility=request.param)
    return DiaData.from_spectra(sp), JaxDiaData.from_spectra(sp)


_DIA_ARRAYS = (
    "cycle", "rt_values", "cycle_rt", "peak_mz", "peak_intensity", "cell_start",
    "peak_is_ghost", "peak_scanbin", "mobility_values",
)
_DIA_SCALARS = (
    "n_cycles", "n_slots", "has_ms1", "has_mobility", "n_scan_bins", "n_bins",
    "bin_mz_min", "coarse_bin_width", "mz_min", "mz_max", "quad_min_mz",
    "quad_max_mz", "n_peaks", "n_stored_peaks", "n_cycles_dev", "cycle_time",
)


def test_diadata_host_arrays_equal(stores):
    ours, theirs = stores
    for name in _DIA_ARRAYS:
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name), err_msg=name)
    for name in _DIA_SCALARS:
        assert getattr(ours, name) == getattr(theirs, name), name


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_device_arrays_equal(stores, stride):
    ours, theirs = stores
    d = ours.device_arrays(stride, "cpu")
    j = {k: np.asarray(v) for k, v in theirs.device_arrays(stride).items()}
    assert d["n_cycles"] == int(j["n_cycles"])
    np.testing.assert_array_equal(d["cell_start"].numpy(), j["cell_start"])
    np.testing.assert_array_equal(d["cycle_rt"].numpy(), j["cycle_rt"])
    # the JAX store is [NR, 4, 128] lane rows of (m/z, intensity, cycle,
    # scan bin); the port's is one (m/z, intensity) row per peak beside a
    # cycle plane (mod 2**16) and a scan-bin plane
    jp = j["peak_packed"].transpose(0, 2, 1).reshape(-1, 4)
    store = d["peak_store"]
    packed = store.packed.numpy()
    assert packed.shape == (len(j["peak_mz"]), 2)
    np.testing.assert_array_equal(packed, jp[: packed.shape[0], :2])
    np.testing.assert_array_equal(store.scanbin.numpy(), jp[: packed.shape[0], 3].astype(np.int32))
    n_stored = ours.n_stored_peaks
    np.testing.assert_array_equal(ours.peak_cycle(), jp[:n_stored, 2].astype(np.int32))
    np.testing.assert_array_equal(store.cycle.numpy()[:n_stored], jp[:n_stored, 2].astype(np.uint16))
    assert (jp[n_stored : packed.shape[0], 1] == 0).all()
    np.testing.assert_array_equal(d["peak_mz"].numpy(), j["peak_mz"])
    np.testing.assert_array_equal(d["peak_intensity"].numpy(), j["peak_intensity"])
    np.testing.assert_array_equal(d["peak_scanbin"].numpy(), j["peak_scanbin"])
    assert [t.dtype for t in store] == [torch.float32, torch.uint16, torch.int16]
    assert all(t.is_contiguous() and t.shape[0] == packed.shape[0] for t in store)
    # the coarse view shares the fine view's peak store
    assert d["peak_store"] is ours.device_arrays(1, "cpu")["peak_store"]


def test_convert_carries_the_jax_state(stores):
    from alphadia_torch.convert import diadata_from_jax

    ours, theirs = stores
    conv = diadata_from_jax(theirs)
    for name in _DIA_ARRAYS:
        np.testing.assert_array_equal(getattr(conv, name), getattr(ours, name), err_msg=name)
    for name in _DIA_SCALARS:
        assert getattr(conv, name) == getattr(ours, name), name


def test_dia_cycle_matches():
    from alphadia_torch.rawdata import determine_dia_cycle
    from alphadia_tpu.rawdata import determine_dia_cycle as jax_cycle

    (sp, _, _), _ = _worlds(1)
    a = determine_dia_cycle(sp.rt, sp.isolation_lower_mz, sp.isolation_upper_mz)
    b = jax_cycle(sp.rt, sp.isolation_lower_mz, sp.isolation_upper_mz)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]


@pytest.mark.parametrize(
    "n,cap", [(1, 16384), (255, 256), (5000, 4096), (12000, 16384), (37000, 8192)]
)
def test_batch_helpers_match(n, cap):
    from alphadia_torch.utils import device as ours
    from alphadia_tpu.utils import device as theirs

    assert ours.batch_schedule(n, cap) == theirs.batch_schedule(n, cap)
    assert ours.effective_batch(cap, n) == theirs.effective_batch(cap, n)
    assert ours.bucket_window(n) == theirs.bucket_window(n)
    assert ours.bucket_count(n) == theirs.bucket_count(n)


def test_npz_raw_file_round_trip(tmp_path):
    """A raw file the JAX package writes reads back in the port as the same
    spectra (and the port's own ``save_npz`` as well), through
    ``RawFileManager`` into a ``DiaData`` equal to the JAX package's, with
    the same RT range."""
    from alphadia_torch.rawdata import load_raw_file, save_npz
    from alphadia_torch.workflow.managers.raw_file_manager import RawFileManager
    from alphadia_tpu.rawdata.source import load_raw_file as jax_load_raw_file
    from alphadia_tpu.rawdata.source import save_npz as jax_save_npz

    (ours, _, _), (theirs, _, _) = _worlds(3, with_mobility=True)
    jax_save_npz(tmp_path / "jax.npz", theirs)
    save_npz(tmp_path / "port.npz", ours)
    for name in ("jax.npz", "port.npz"):
        back, ref = load_raw_file(tmp_path / name), jax_load_raw_file(tmp_path / "jax.npz")
        for f in _SPECTRA_FIELDS:
            np.testing.assert_array_equal(getattr(back, f), getattr(ref, f), err_msg=f)
            np.testing.assert_array_equal(getattr(back, f), getattr(theirs, f), err_msg=f)
    manager = RawFileManager({"general": {"thread_count": 1}, "tpu": {"coarse_bin_width": 1.0, "n_scan_bins": 8}})
    dia = manager.get_dia_data_object(str(tmp_path / "port.npz"))
    jd = JaxDiaData.from_spectra(theirs, n_scan_bins=8)
    assert (dia.rt_min, dia.rt_max) == (jd.rt_min, jd.rt_max)
    np.testing.assert_array_equal(dia.cell_start, jd.cell_start)
    np.testing.assert_array_equal(dia.peak_mz, jd.peak_mz)
    assert manager.stats["n_cycles"] == jd.n_cycles and manager.stats["has_mobility"]


@pytest.mark.parametrize("with_mobility", [False, True])
def test_sequence_world_follows_chem(with_mobility):
    """``from_sequence``: the library's precursor and fragment m/z are the
    JAX package's ``chem`` values for each sequence, charge and series
    number (less the planted ppm bias, rounded to float32) and lie in the
    generator's fragment range, the isotope
    envelope is the sequence's, every precursor lies in the isolation
    range, and what does not come from the sequence equals the default
    world's."""
    from alphadia_tpu.library import chem as jax_chem

    cfg = dict(n_peptides=60, n_windows=4, n_cycles=60, noise_peaks_per_spectrum=20, seed=3, with_mobility=with_mobility)
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(**cfg, from_sequence=True))
    _, prec0, frag0 = make_synthetic_dia(SyntheticConfig(**cfg))
    seqs, charge = [str(x) for x in prec["sequence"]], prec["charge"].astype(int)
    want = np.array([jax_chem.precursor_mz(q, z) for q, z in zip(seqs, charge)])
    np.testing.assert_allclose(prec["mz_library"], want, rtol=1e-6, atol=0)
    assert ((want > 400.5) & (want < 999.5)).all()
    env = jax_chem.isotope_envelopes(jax_chem.peptide_compositions(seqs), k_max=3)
    np.testing.assert_allclose(np.stack([prec[f"i_{k}"] for k in range(3)], 1), env / env[:, :1], rtol=1e-6)
    F = 10
    for i, q in enumerate(seqs):
        ladders = jax_chem.fragment_mz_arrays(q)
        rows = slice(i * F, (i + 1) * F)
        t, z, k, pos = frag["type"][rows], frag["charge"][rows], frag["number"][rows], frag["position"][rows]
        assert len(set(zip(t, z, k))) == F and (k >= 2).all() and (k <= len(q) - 1).all()
        site = np.where(t == 98, k - 1, len(q) - 1 - k.astype(int))
        np.testing.assert_array_equal(pos, site)
        mz = np.array([ladders[f"{chr(a)}_z{b}"][c] for a, b, c in zip(t, z, site)])
        np.testing.assert_allclose(frag["mz_library"][rows], mz, rtol=1e-6, atol=0)
        assert ((mz >= 200.0) & (mz <= 1400.0)).all()
    for c in ("rt_library", "_truth_rt", "_truth_detectable", "mobility_library", "proteins"):
        np.testing.assert_array_equal(prec[c], prec0[c])
    for c in ("intensity", "type"):
        np.testing.assert_array_equal(frag[c], frag0[c])


@pytest.mark.parametrize("name", ["run.raw"])
def test_raw_formats_without_a_reader_raise(tmp_path, name):
    """Formats without a reader raise as unsupported; the formats the error
    calls supported are those that read, ``.hdf`` and ``.d`` among them."""
    from alphadia_torch.rawdata import load_raw_file

    with pytest.raises(ValueError, match="Unsupported") as e:
        load_raw_file(tmp_path / name)
    supported = str(e.value).split("Supported:")[1]
    assert ".mzML" in supported and ".npz" in supported and ".d (Bruker TDF)" in supported
    assert ".hdf (alphaRaw)" in supported


@pytest.mark.parametrize("name", ["run.hdf", "run.h5", "run.hdf5"])
def test_hdf_raw_files_read_as_jax(tmp_path, name):
    """``.hdf`` / ``.h5`` / ``.hdf5`` read through the alphaRaw reader: a
    spectra cache of the JAX package gives its arrays."""
    from alphadia_torch.rawdata import load_raw_file
    from alphadia_tpu.rawdata.hdf import save_spectra_hdf

    spectra, _, _ = make_synthetic_dia(SyntheticConfig(n_peptides=30, n_windows=2, n_cycles=20, seed=4))
    save_spectra_hdf(tmp_path / name, spectra)
    ours = load_raw_file(tmp_path / name, thread_count=2)
    for f in ("rt", "ms_level", "isolation_lower_mz", "isolation_upper_mz", "peak_start_idx", "peak_stop_idx", "mz",
              "intensity"):
        a, b = getattr(spectra, f), getattr(ours, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert ours.mobility is None


def test_a_missing_d_directory_raises(tmp_path):
    """``.d`` reads through the Bruker reader, which names what a TDF
    directory needs."""
    from alphadia_torch.rawdata import load_raw_file
    from alphadia_torch.rawdata.bruker_tdf import TdfFormatError

    with pytest.raises(TdfFormatError, match="not a TDF .d directory"):
        load_raw_file(tmp_path / "run.d")
