"""The port's HDF modules against the JAX package's, on the CPU, on numpy
inputs made from a seed; every comparison exact.

- ``rawdata/hdf``: ``save_spectra_hdf`` / ``read_alpharaw_hdf`` both ways
  (the port reads JAX's caches, JAX reads the port's; 3D and 4D), and
  alphaRaw's layout written by h5py (at the root and under ``ms_data``,
  the column aliases, ``rt_unit``, per-peak mobility, the 10 h warning,
  the missing-column and missing-group errors).
- ``library/speclib``: ``SpecLibBase`` and ``SpecLibFlat`` ``save_hdf`` /
  ``load_hdf`` both ways, with ``bool``, text and missing-text columns.
- ``library/loader.load_speclib_hdf`` on alphabase's layout (the frames
  under ``library``, variable-length strings, a 2-D dataset and a group
  skipped).
- ``RawFileManager``'s mzML cache: written beside the source, reused while
  fresh, parsed anew when stale or unreadable, only logged when it cannot
  be written, none for other formats; each case against JAX's manager.
"""

import logging
import os

import h5py
import numpy as np
import pandas as pd
import pytest

from alphadia_torch.library.loader import load_speclib_hdf
from alphadia_torch.library.speclib import SpecLibBase, SpecLibFlat
from alphadia_torch.rawdata.hdf import read_alpharaw_hdf, save_spectra_hdf
from alphadia_torch.testing.mzml_writer import write_mzml
from alphadia_torch.testing.synthetic import SyntheticConfig, make_synthetic_dia
from alphadia_torch.workflow.managers.raw_file_manager import RawFileManager
from alphadia_tpu.library import loader as jax_loader
from alphadia_tpu.library import speclib as jax_speclib
from alphadia_tpu.rawdata import hdf as jax_hdf
from alphadia_tpu.workflow.managers.raw_file_manager import RawFileManager as JaxRawFileManager

pytest_plugins = ("torch_port_plugin",)

FIELDS = ("rt", "ms_level", "isolation_lower_mz", "isolation_upper_mz", "peak_start_idx", "peak_stop_idx", "mz",
          "intensity", "mobility")


def same_spectra(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f


@pytest.fixture(scope="module")
def worlds():
    return {
        kind: make_synthetic_dia(
            SyntheticConfig(n_peptides=60, n_windows=3, n_cycles=40, seed=9, with_mobility=kind == "4d")
        )[0]
        for kind in ("3d", "4d")
    }


@pytest.fixture(params=["3d", "4d"])
def spectra(request, worlds):
    return worlds[request.param]


def test_spectra_cache_both_ways(tmp_path, spectra):
    jax_hdf.save_spectra_hdf(tmp_path / "jax.hdf", spectra)
    save_spectra_hdf(tmp_path / "port.hdf", spectra, thread_count=3)
    for path in ("jax.hdf", "port.hdf"):
        ours, theirs = read_alpharaw_hdf(tmp_path / path, thread_count=2), jax_hdf.read_alpharaw_hdf(tmp_path / path)
        same_spectra(theirs, ours)
        same_spectra(spectra, ours)
    with h5py.File(tmp_path / "port.hdf") as f:
        assert f.attrs["format"] == "alphadia_tpu_spectra"
        assert all(f[k].compression == "gzip" and f[k].compression_opts == 1 for k in f)


def _alpharaw(path, spectra, nested=True, aliases=False, rt_unit=None, rt_factor=1 / 60.0, drop=(), mobility=None):
    """alphaRaw's layout as h5py writes it: RT in minutes by default, a
    vlen-string ``rt_unit`` attribute, a text column, shuffle+deflate on one
    column and LZF on another."""
    names = {
        "rt": "rt_values" if aliases else "rt",
        "isolation_lower_mz": "precursor_mz_lower" if aliases else "isolation_lower_mz",
        "isolation_upper_mz": "precursor_mz_upper" if aliases else "isolation_upper_mz",
        "peak_start_idx": "peak_start_idxes" if aliases else "peak_start_idx",
        "peak_stop_idx": "peak_stop_idxes" if aliases else "peak_stop_idx",
        "mz": "mz_values" if aliases else "mz",
        "intensity": "intensity_values" if aliases else "intensity",
    }
    with h5py.File(path, "w") as f:
        g = f.create_group("ms_data") if nested else f
        spec, peak = g.create_group("spectrum_df"), g.create_group("peak_df")
        if rt_unit is not None:
            spec.attrs["rt_unit"] = rt_unit
        cols = {
            "rt": spectra.rt.astype(np.float64) * rt_factor,
            "ms_level": spectra.ms_level.astype(np.int8),
            "isolation_lower_mz": spectra.isolation_lower_mz.astype(np.float64),
            "isolation_upper_mz": spectra.isolation_upper_mz.astype(np.float64),
            "peak_start_idx": spectra.peak_start_idx,
            "peak_stop_idx": spectra.peak_stop_idx,
        }
        for k, v in cols.items():
            if k not in drop:
                spec.create_dataset(names.get(k, k), data=v, compression="gzip", shuffle=k == "rt")
        spec.create_dataset("scan_id", data=np.array([f"scan={i}" for i in range(len(spectra.rt))], dtype=object),
                            dtype=h5py.string_dtype())
        if "mz" not in drop:
            peak.create_dataset(names["mz"], data=spectra.mz.astype(np.float64), compression="lzf")
        peak.create_dataset(names["intensity"], data=spectra.intensity, compression="gzip", compression_opts=1)
        if mobility is not None:
            peak.create_dataset(mobility, data=spectra.mobility, compression="gzip")


LAYOUTS = {
    "nested_minutes": ("3d", dict()),
    "root_minutes_unit": ("3d", dict(nested=False, rt_unit="minute")),
    "aliases_seconds": ("3d", dict(aliases=True, rt_unit="second", rt_factor=1.0)),
    "nested_minutes_4d_without_mobility": ("4d", dict()),
    "mobility": ("4d", dict(mobility="mobility")),
    "mobility_alias": ("4d", dict(aliases=True, mobility="inv_ion_mobility")),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_alpharaw_layout_reads_as_jax(tmp_path, worlds, layout):
    kind, kw = LAYOUTS[layout]
    spectra = worlds[kind]
    _alpharaw(tmp_path / "run.hdf", spectra, **kw)
    ours, theirs = read_alpharaw_hdf(tmp_path / "run.hdf"), jax_hdf.read_alpharaw_hdf(tmp_path / "run.hdf")
    same_spectra(theirs, ours)
    assert ours.has_mobility == ("mobility" in kw)
    np.testing.assert_allclose(ours.rt, spectra.rt, rtol=1e-6)


ERRORS = {
    "missing_mz": (dict(drop=("mz",)), "missing mz column"),
    "missing_offsets": (dict(drop=("peak_start_idx",)), "missing peak offsets column"),
    "unknown_unit": (dict(rt_unit="hour"), "unknown rt_unit attribute 'hour'"),
    "no_groups": (None, "no spectrum_df/peak_df groups"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_alpharaw_errors_as_jax(tmp_path, spectra, case):
    kw, message = ERRORS[case]
    path = tmp_path / "run.hdf"
    if kw is None:
        with h5py.File(path, "w") as f:
            f.create_dataset("x", data=[1])
    else:
        _alpharaw(path, spectra, **kw)
    for reader in (read_alpharaw_hdf, jax_hdf.read_alpharaw_hdf):
        with pytest.raises(ValueError, match=message):
            reader(path)


def test_a_run_past_10_hours_warns_as_jax(tmp_path, spectra, caplog):
    _alpharaw(tmp_path / "run.hdf", spectra, rt_factor=20.0)  # past 10 h once read as minutes
    with caplog.at_level(logging.WARNING):
        ours = read_alpharaw_hdf(tmp_path / "run.hdf")
    assert any("minutes->seconds conversion" in r.message for r in caplog.records)
    same_spectra(jax_hdf.read_alpharaw_hdf(tmp_path / "run.hdf"), ours)


# ---------------------------------------------------------------------------
# libraries
# ---------------------------------------------------------------------------
def _frames(seed=3, n=40):
    rng = np.random.default_rng(seed)
    seqs = np.array(["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), int(k))) for k in rng.integers(7, 15, n)],
                    dtype=object)
    prec = {
        "sequence": seqs,
        "mods": np.array(["Oxidation@M" if i % 5 == 0 else "" for i in range(n)], dtype=object),
        "proteins": np.array([f"P{i % 7};Q{i % 3}" if i % 11 else np.nan for i in range(n)], dtype=object),
        "charge": rng.integers(1, 5, n).astype(np.uint8),
        "precursor_mz": rng.uniform(400, 1200, n).astype(np.float32),
        "rt": rng.uniform(0, 1, n),
        "decoy": (np.arange(n) % 2).astype(np.uint8),
        "is_shared": rng.integers(0, 2, n).astype(bool),
        "mod_seq_hash": rng.integers(0, 2**62, n).astype(np.int64),
        "frag_start_idx": np.arange(n, dtype=np.uint32) * 3,
        "frag_stop_idx": np.arange(n, dtype=np.uint32) * 3 + 3,
    }
    frag = {
        "mz_library": rng.uniform(200, 1400, 3 * n).astype(np.float32),
        "intensity": rng.exponential(size=3 * n).astype(np.float32),
        "type": rng.choice([98, 121], 3 * n).astype(np.uint8),
        "is_top": rng.integers(0, 2, 3 * n).astype(bool),
    }
    mz = rng.uniform(100, 1000, (3 * n, 4)).astype(np.float32)
    inten = rng.uniform(0, 1, (3 * n, 4)).astype(np.float32)
    return prec, frag, mz, inten, ["b_z1", "b_z2", "y_z1", "y_z2"]


def _text(a):
    return [str(x) for x in a]


def assert_frame(jax_frame: pd.DataFrame, frame: dict, written: dict):
    assert list(jax_frame.columns) == list(frame) == list(written)
    for c in written:
        w, ours, theirs = np.asarray(written[c]), frame[c], jax_frame[c].to_numpy()
        if w.dtype == object:
            assert ours.dtype == object and theirs.dtype == object
            assert list(ours) == _text(w) == list(theirs), c
        else:
            assert ours.dtype == w.dtype == theirs.dtype and ours.tobytes() == w.tobytes() == theirs.tobytes(), c


def test_flat_library_both_ways(tmp_path):
    prec, frag, *_ = _frames()
    SpecLibFlat(prec, frag).save_hdf(tmp_path / "port.hdf", thread_count=2)
    jax_speclib.SpecLibFlat(pd.DataFrame(prec), pd.DataFrame(frag)).save_hdf(tmp_path / "jax.hdf")
    for path in ("port.hdf", "jax.hdf"):
        ours, theirs = SpecLibFlat.load_hdf(tmp_path / path), jax_speclib.SpecLibFlat.load_hdf(tmp_path / path)
        assert_frame(theirs.precursor_df, ours.precursor_df, prec)
        assert_frame(theirs.fragment_df, ours.fragment_df, frag)
        assert ours.precursor_df["is_shared"].dtype == bool
    with h5py.File(tmp_path / "port.hdf") as f:
        assert f.attrs["format"] == "alphadia_tpu_speclib_flat" and f["precursor_df"]["sequence"].dtype.kind == "S"


def test_base_library_both_ways(tmp_path):
    prec, _, mz, inten, types = _frames()
    SpecLibBase(prec, mz, inten, types).save_hdf(tmp_path / "port.hdf")
    jax_speclib.SpecLibBase(pd.DataFrame(prec), pd.DataFrame(mz, columns=types),
                            pd.DataFrame(inten, columns=types)).save_hdf(tmp_path / "jax.hdf")
    for path in ("port.hdf", "jax.hdf"):
        ours, theirs = SpecLibBase.load_hdf(tmp_path / path), jax_speclib.SpecLibBase.load_hdf(tmp_path / path)
        assert_frame(theirs.precursor_df, ours.precursor_df, prec)
        assert ours.charged_frag_types == types == list(theirs.fragment_mz_df.columns)
        assert ours.fragment_mz.tobytes() == mz.tobytes() == theirs.fragment_mz_df.to_numpy().tobytes()
        assert ours.fragment_intensity.tobytes() == inten.tobytes()
        assert type(load_speclib_hdf(tmp_path / path)) is SpecLibBase


def test_alphabase_layout_loads_as_jax(tmp_path):
    prec, _, mz, inten, types = _frames(n=12)
    with h5py.File(tmp_path / "ab.hdf", "w") as f:
        lib = f.create_group("library")
        g = lib.create_group("precursor_df")
        for k, v in prec.items():
            if v.dtype == object:
                g.create_dataset(k, data=np.array([str(x) for x in v], dtype=object), dtype=h5py.string_dtype())
            else:
                g.create_dataset(k, data=v)
        g.create_dataset("matrix", data=np.zeros((12, 2)))  # 2-D: skipped
        g.create_group("nested")  # a group: skipped
        for name, m in (("fragment_mz_df", mz), ("fragment_intensity_df", inten)):
            fg = lib.create_group(name)
            for j, t in enumerate(types):
                fg.create_dataset(t, data=m[:, j])
    ours, theirs = load_speclib_hdf(tmp_path / "ab.hdf"), jax_loader.load_speclib_hdf(tmp_path / "ab.hdf")
    assert list(ours.precursor_df) == list(theirs.precursor_df.columns) == sorted(prec)
    for c in theirs.precursor_df.columns:
        a, b = theirs.precursor_df[c].to_numpy(), ours.precursor_df[c]
        if a.dtype == object:  # h5py gives JAX's frame bytes; the port reads str
            assert b.dtype == object and [x.decode() for x in a] == list(b) == _text(prec[c]), c
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), c
    # the group's datasets in name order, the fragment types likewise
    assert ours.charged_frag_types == sorted(types) == list(theirs.fragment_mz_df.columns)
    assert ours.fragment_mz.tobytes() == theirs.fragment_mz_df.to_numpy().tobytes()
    assert ours.fragment_intensity.tobytes() == theirs.fragment_intensity_df.to_numpy().tobytes()


def test_unrecognized_library_layout_raises_as_jax(tmp_path):
    with h5py.File(tmp_path / "x.hdf", "w") as f:
        f.create_dataset("x", data=[1])
    for load in (load_speclib_hdf, jax_loader.load_speclib_hdf):
        with pytest.raises(ValueError, match="Unrecognized speclib HDF layout"):
            load(tmp_path / "x.hdf")


# ---------------------------------------------------------------------------
# the mzML cache
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_mzml(tmp_path_factory):
    s, _, _ = make_synthetic_dia(SyntheticConfig(n_peptides=40, n_windows=2, n_cycles=30, seed=12))
    path = tmp_path_factory.mktemp("mzml") / "run.mzML"
    write_mzml(path, s)
    return path


def _both(path):
    ours = RawFileManager()._load_with_cache(str(path), thread_count=2)
    theirs = JaxRawFileManager()._load_with_cache(str(path), thread_count=1)
    return ours, theirs


CACHE_CASES = ("written_then_reused", "stale", "unreadable", "unwritable", "other_format", "gzipped")


@pytest.mark.parametrize("case", CACHE_CASES)
def test_mzml_cache_as_jax(tmp_path, small_mzml, case, caplog):
    import gzip
    import shutil

    src = tmp_path / "run.mzML"
    shutil.copy(small_mzml, src)
    if case == "gzipped":
        src = tmp_path / "run.mzML.gz"
        src.write_bytes(gzip.compress(small_mzml.read_bytes()))
    cache = src.parent / (src.name + ".cache.hdf")
    parsed = RawFileManager()._load_with_cache(str(src), thread_count=1) if case != "other_format" else None

    if case in ("written_then_reused", "gzipped"):
        assert cache.exists()
        same_spectra(jax_hdf.read_alpharaw_hdf(cache), parsed)
        # a fresh cache is what is read: mark it and read it through both
        marked = parsed.select(np.arange(parsed.n_spectra) < 10)
        save_spectra_hdf(cache, marked)
        os.utime(cache, (src.stat().st_mtime + 5, src.stat().st_mtime + 5))
        ours, theirs = _both(src)
        same_spectra(marked, ours)
        same_spectra(theirs, ours)
    elif case == "stale":
        save_spectra_hdf(cache, parsed.select(np.arange(parsed.n_spectra) < 10))
        os.utime(cache, (src.stat().st_mtime - 100, src.stat().st_mtime - 100))
        ours, theirs = _both(src)
        same_spectra(parsed, ours)
        same_spectra(theirs, ours)
        same_spectra(parsed, read_alpharaw_hdf(cache))  # written anew
    elif case == "unreadable":
        cache.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\0" * 40)
        os.utime(cache, (src.stat().st_mtime + 5, src.stat().st_mtime + 5))
        with caplog.at_level(logging.WARNING):
            ours = RawFileManager()._load_with_cache(str(src), thread_count=1)
        assert any("spectra cache unreadable" in r.message for r in caplog.records)
        same_spectra(parsed, ours)
        same_spectra(parsed, jax_hdf.read_alpharaw_hdf(cache))
    elif case == "unwritable":
        cache.unlink()
        cache.mkdir()
        ours = RawFileManager()._load_with_cache(str(src), thread_count=1)
        same_spectra(parsed, ours)
        assert cache.is_dir() and not list(tmp_path.glob("*.part"))
    else:
        npz = tmp_path / "run.npz"
        from alphadia_torch.rawdata import save_npz

        s, _, _ = make_synthetic_dia(SyntheticConfig(n_peptides=20, n_windows=2, n_cycles=10, seed=1))
        save_npz(npz, s)
        ours, theirs = _both(npz)
        same_spectra(theirs, ours)
        assert sorted(p.name for p in tmp_path.iterdir()) == ["run.mzML", "run.npz"]


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------
def test_the_committed_fixture_reads_with_its_sha256(tmp_path):
    """The port reads every file of ``alphadia_torch/testing/data/hdf_*``
    (h5py's, through the JAX package's writers) with the sha256 and
    attributes that h5py's reading gave; written again by the port's
    writer, each reads back the same through the port and through h5py."""
    import json

    from torch_hdf_fixture import DATA, FILES, file_record, rewritten

    record = json.loads((DATA / "hdf_fixture.json").read_text())
    for name in FILES:
        want = record["files"][name]
        assert file_record(DATA / name) == want, name
        assert file_record(DATA / name, reader="h5py") == want, name
        rewritten(DATA / name, tmp_path / name, threads=2)
        assert file_record(tmp_path / name) == want, name
        assert file_record(tmp_path / name, reader="h5py") == want, name
    same_spectra(read_alpharaw_hdf(DATA / "hdf_spectra_3d.hdf"), read_alpharaw_hdf(DATA / "hdf_alpharaw.hdf"))


@pytest.mark.parametrize("libver", ["latest", "v108_latest", "track_order"])
def test_new_style_files_read_as_jax(tmp_path, spectra, libver):
    """A spectra file and a base library written by h5py with ``libver=
    "latest"``, ``("v108", "latest")`` or ``track_order=True`` (the JAX
    writers under h5py's global ``track_order``): both packages' readers
    give the same arrays and frames."""
    prec, _, mz, inten, types = _frames()
    kw = {"latest": dict(libver="latest"), "v108_latest": dict(libver=("v108", "latest")),
          "track_order": dict(track_order=True)}[libver]
    original = h5py.File

    def file_with(path, mode="r", **k):
        return original(path, mode, **({**kw, **k} if mode == "w" else k))

    h5py.get_config().track_order = libver == "track_order"
    try:
        h5py.File = file_with
        jax_hdf.save_spectra_hdf(tmp_path / "run.hdf", spectra)
        jax_speclib.SpecLibBase(pd.DataFrame(prec), pd.DataFrame(mz, columns=types),
                                pd.DataFrame(inten, columns=types)).save_hdf(tmp_path / "lib.hdf")
    finally:
        h5py.File = original
        h5py.get_config().track_order = False
    for name in ("run.hdf", "lib.hdf"):
        with h5py.File(tmp_path / name) as f:
            if libver == "track_order":
                assert f["/"].id.get_create_plist().get_link_creation_order()
            else:
                assert (tmp_path / name).read_bytes()[8] in (2, 3)  # the superblock's version
    same_spectra(jax_hdf.read_alpharaw_hdf(tmp_path / "run.hdf"), read_alpharaw_hdf(tmp_path / "run.hdf"))
    ours, theirs = load_speclib_hdf(tmp_path / "lib.hdf"), jax_loader.load_speclib_hdf(tmp_path / "lib.hdf")
    assert_frame(theirs.precursor_df, ours.precursor_df, prec)
    assert ours.fragment_mz.tobytes() == theirs.fragment_mz_df.to_numpy().tobytes()
