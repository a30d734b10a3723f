"""The port's HDF5 reader and writer (``alphadia_torch/utils/hdf5.py``)
against h5py, on the CPU.

- The port reads what h5py writes at its defaults bit for bit: every dtype
  of the subset, compact, contiguous and chunked layouts, deflate, shuffle,
  fletcher32 and LZF (alone and together), chunk B-trees of several levels,
  edge chunks, unwritten chunks (the fill value), object-header
  continuation blocks, variable-length strings in attributes and datasets.
- h5py reads what the port writes bit for bit (also on several threads,
  whose count does not change a byte); the port's file of a library frame
  is at most 1.5 times h5py's at gzip level 1.
- The port reads what h5py writes with ``libver="latest"``,
  ``libver=("v108", "latest")`` and ``track_order=True`` bit for bit:
  compact and dense groups (9 and 200 links), 20 attributes, every chunk
  index of the version-4 layout (single chunk, implicit, fixed array with
  pages, extensible array with secondary blocks and paged data blocks,
  version-2 B-tree with internal nodes) under no filter, gzip+shuffle, LZF
  and fletcher32, variable-length strings; each file holds the structures
  it is meant to test.
- Structures outside the subset raise ``ValueError`` naming themselves
  (big-endian and compound types, other filters, soft links in either kind
  of group, external links, shared messages, variable-length sequences).
- Truncated and corrupted files, ``latest`` ones too, raise ``ValueError``;
  a fletcher32 or lookup3 checksum mismatch raises.
"""

import os
import struct

import h5py
import numpy as np
import pytest

from alphadia_torch.utils import hdf5

pytest_plugins = ("torch_port_plugin",)

RNG = np.random.default_rng(2024)
N = 5000


def _column(kind: str, n: int = N, rng=RNG):
    if kind in ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64"):
        info = np.iinfo(kind)
        return rng.integers(info.min, info.max, n, dtype=kind, endpoint=True)
    if kind in ("float16", "float32", "float64"):
        return (rng.normal(size=n) * 1e3).astype(kind)
    if kind == "bool":
        return rng.integers(0, 2, n).astype(bool)
    if kind == "S":
        return np.array([f"PEPTIDE{i}"[: 1 + i % 9] for i in rng.integers(0, 10**6, n)]).astype("S")
    if kind == "vlen":
        return np.array([("ä" if i % 7 == 0 else "") + "x" * (i % 13) for i in rng.integers(0, 1000, n)], dtype=object)
    raise KeyError(kind)


DTYPES = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64", "float16", "float32", "float64",
          "bool", "S", "vlen")


def _h5py_data(arr):
    return dict(data=arr, dtype=h5py.string_dtype()) if arr.dtype == object else dict(data=arr)


def _h5py_value(v):
    """h5py's reading of a dataset in the port's terms: variable-length
    strings as ``str``."""
    if type(v) is bytes:
        return v.decode()
    if isinstance(v, np.ndarray) and v.dtype == object:
        return np.array([x.decode() if isinstance(x, bytes) else x for x in v.reshape(-1)], dtype=object).reshape(v.shape)
    return v


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype == object:
        assert a.tolist() == b.tolist()
    else:
        assert a.tobytes() == b.tobytes()


def _read(path, threads=1) -> dict:
    """Every dataset of a file through the port's reader, ``{path: array}``."""
    out = {}
    with hdf5.File(path, threads=threads) as f:
        def walk(g, prefix):
            for k in g:
                node = g[k]
                if isinstance(node, hdf5.Group):
                    walk(node, f"{prefix}{k}/")
                else:
                    out[f"{prefix}{k}"] = node[()]

        walk(f, "")
    return out


def _port_reads_like_h5py(path):
    with h5py.File(path, "r") as f:
        want = {}
        f.visititems(lambda k, o: want.__setitem__(k, _h5py_value(o[()])) if isinstance(o, h5py.Dataset) else None)
        want_attrs = {k: dict(o.attrs) for k, o in [("", f)] + [(k, f[k]) for k in want]}
    got = _read(path, threads=3)
    assert sorted(got) == sorted(want)
    for k in want:
        _equal(got[k], want[k])
    with hdf5.File(path) as f:
        for k, attrs in want_attrs.items():
            node = f[k] if k else f
            assert sorted(node.attrs) == sorted(attrs)
            for name, v in attrs.items():
                _equal(node.attrs[name], v)
    return got


# ---------------------------------------------------------------------------
# the port reads h5py
# ---------------------------------------------------------------------------
FILTERS = {
    "contiguous": {},
    "gzip1": dict(compression="gzip", compression_opts=1),
    "gzip9_shuffle": dict(compression="gzip", compression_opts=9, shuffle=True),
    "fletcher32": dict(fletcher32=True),
    "shuffle_gzip_fletcher32": dict(compression="gzip", shuffle=True, fletcher32=True),
    "lzf": dict(compression="lzf"),
    "lzf_shuffle": dict(compression="lzf", shuffle=True),
    "one_element_chunks_3_levels": dict(chunks=(1,), compression="gzip"),
}


@pytest.mark.parametrize("filters", sorted(FILTERS))
def test_port_reads_every_dtype_under_each_filter_as_h5py(tmp_path, filters):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w") as f:
        for kind in DTYPES:
            # HDF5 refuses fletcher32 on variable-length data
            opts = {} if kind == "vlen" and "fletcher32" in FILTERS[filters] else FILTERS[filters]
            f.create_dataset(kind, **_h5py_data(_column(kind)), **opts)
    got = _port_reads_like_h5py(path)
    assert got["bool"].dtype == bool and got["vlen"].dtype == object
    assert isinstance(got["vlen"][0], str)


def test_port_reads_layouts_edges_fill_and_attributes_as_h5py(tmp_path):
    path = tmp_path / "layouts.h5"
    with h5py.File(path, "w") as f:
        f.attrs["format"] = "alphadia_tpu_spectra"
        f.attrs["n_rows"] = 17
        f.attrs["pi"] = 3.25
        f.attrs["flag"] = np.bool_(True)
        f.attrs["columns"] = ["mz", "intensity", ""]
        f.attrs["fixed"] = np.bytes_(b"minute")
        f.attrs["ints"] = np.arange(6, dtype=np.int16).reshape(2, 3)
        # compact layout: a small dataset kept in its object header
        space = h5py.h5s.create_simple((4,))
        plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        plist.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT32, space, plist).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(4, dtype=np.int32)
        )
        f.create_dataset("scalar", data=np.float64(2.5))
        f.create_dataset("scalar_str", data="second", dtype=h5py.string_dtype())
        f.create_dataset("empty", data=np.zeros(0, np.float32), compression="gzip")
        f.create_dataset("empty_contiguous", data=np.zeros(0, np.int64))
        f.create_dataset("edges_2d", data=RNG.normal(size=(103, 37)), chunks=(10, 8), compression="gzip", shuffle=True)
        f.create_dataset("edges_3d", data=RNG.integers(0, 9, (9, 5, 7)).astype(np.int8), chunks=(4, 2, 3))
        d = f.create_dataset("unwritten", shape=(1000,), chunks=(64,), dtype=np.int32, fillvalue=-7, compression="gzip")
        d[100:300] = np.arange(200)
        f.create_dataset("never_written", shape=(50,), dtype=np.float32, fillvalue=1.5, chunks=(8,))
        g = f.create_group("ms_data/spectrum_df")
        g.create_dataset("rt", data=np.linspace(0, 1, 10), compression="gzip")
        g.attrs["rt_unit"] = "minute"
        f.create_group("empty_group")
    got = _port_reads_like_h5py(path)
    assert got["unwritten"][0] == -7 and got["unwritten"][150] == 50
    with hdf5.File(path) as f:
        assert f.attrs["format"] == "alphadia_tpu_spectra" and isinstance(f.attrs["format"], str)
        assert f.attrs["n_rows"] == 17 and list(f.attrs["columns"]) == ["mz", "intensity", ""]
        assert "spectrum_df" in f["ms_data"] and f["ms_data/spectrum_df"].attrs["rt_unit"] == "minute"
        assert list(f["empty_group"]) == [] and list(f) == sorted(f)


def test_port_reads_continuation_blocks_and_big_groups_as_h5py(tmp_path):
    """Attributes added after a group's datasets spill its object header
    into continuation blocks; 300 members need several symbol table nodes
    and a group B-tree of two levels."""
    path = tmp_path / "cont.h5"
    with h5py.File(path, "w") as f:
        g = f.create_group("fragment_mz_df")
        for i in range(300):
            g.create_dataset(f"col_{i:03d}", data=np.full(3, i, np.float32), compression="gzip")
        g.attrs["n_rows"] = 3
        g.attrs["columns"] = [f"col_{i:03d}" for i in range(300)]
        for i in range(40):
            g.attrs[f"extra_{i}"] = np.arange(i + 1, dtype=np.float64)
    raw = path.read_bytes()
    with hdf5.File(path) as f:
        reader = f._reader
        n_cont = sum(1 for addr in [f._members["fragment_mz_df"]] for t, *_ in _raw_messages(raw, addr) if t == 0x10)
        assert n_cont >= 1
        assert len(f["fragment_mz_df"]) == 300 and reader is not None
    _port_reads_like_h5py(path)


def _raw_messages(raw: bytes, addr: int):
    """The first block's messages of a version-1 object header."""
    size = struct.unpack_from("<I", raw, addr + 8)[0]
    p = addr + 16
    while p < addr + 16 + size:
        t, n = struct.unpack_from("<HH", raw, p)
        yield t, raw[p + 8 : p + 8 + n]
        p += 8 + n


def test_port_reads_a_user_block(tmp_path):
    path = tmp_path / "ub.h5"
    with h5py.File(path, "w", userblock_size=1024) as f:
        f.create_dataset("x", data=np.arange(100, dtype=np.uint16), compression="gzip")
    _port_reads_like_h5py(path)


# ---------------------------------------------------------------------------
# h5py reads the port
# ---------------------------------------------------------------------------
SHAPES = {"small": (7,), "one_chunk": (1000,), "multi_level": (400_000,), "edge_2d": (301, 13), "empty": (0,)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_h5py_reads_the_writer_bit_for_bit(tmp_path, shape):
    n = int(np.prod(SHAPES[shape]))
    arrays = {k: _column(k, n).reshape(SHAPES[shape]) for k in DTYPES if not (k == "vlen" and n > 50_000)}
    root = hdf5.Group({"format": "alphadia_tpu_speclib_flat", "n_rows": n, "columns": list(arrays), "ratio": 0.5})
    g = root.create_group("precursor_df", {"n_rows": n})
    for k, a in arrays.items():
        g.create_dataset(k, a)
    root.create_dataset("scalar", np.int64(-3))
    root.create_group("empty_group", {"note": "no members"})
    path = tmp_path / "port.h5"
    hdf5.write(path, root, threads=1)
    with h5py.File(path, "r") as f:
        assert f.attrs["format"] == "alphadia_tpu_speclib_flat" and f.attrs["n_rows"] == n
        assert list(f.attrs["columns"]) == list(arrays) and f.attrs["ratio"] == 0.5
        for k, a in arrays.items():
            d = f["precursor_df"][k]
            _equal(_h5py_value(d[()]), a)
            if a.ndim == 1 and n > 20:  # a lookup through the chunk B-tree
                _equal(_h5py_value(d[n // 3 : n // 3 + 11]), a[n // 3 : n // 3 + 11])
            if n:
                assert d.compression == "gzip" and d.compression_opts == 1
                assert d.chunks == h5py._hl.filters.guess_chunk(a.shape, None, 16 if a.dtype == object else a.dtype.itemsize)
        assert f["scalar"][()] == -3
        assert list(f["empty_group"]) == [] and f["empty_group"].attrs["note"] == "no members"
    assert (tmp_path / "port.h5").read_bytes() == _rewritten(root, tmp_path / "threads.h5", threads=4)
    _port_reads_like_h5py(path)


def _rewritten(root, path, threads):
    hdf5.write(path, root, threads=threads)
    return path.read_bytes()


def test_the_writer_is_deterministic_and_has_no_times(tmp_path):
    root = hdf5.Group({"format": "x"})
    root.create_group("g").create_dataset("a", np.arange(10_000, dtype=np.float32))
    a, b = _rewritten(root, tmp_path / "a.h5", 1), _rewritten(root, tmp_path / "b.h5", 2)
    assert a == b
    with h5py.File(tmp_path / "a.h5", "r") as f:
        info = h5py.h5g.get_objinfo(f["g"]["a"].id)
        assert info.mtime == 0


def test_the_writer_is_at_most_1p5_times_h5py(tmp_path):
    """A library-like frame (floats, ids, flags, sequences) at gzip level 1."""
    n = 200_000
    frame = {
        "mz_library": (RNG.uniform(200, 1400, n)).astype(np.float32),
        "intensity": RNG.exponential(size=n).astype(np.float32),
        "precursor_idx": np.repeat(np.arange(n // 12), 12)[:n].astype(np.uint32),
        "type": RNG.choice([98, 121], n).astype(np.uint8),
        "decoy": RNG.integers(0, 2, n).astype(bool),
        "sequence": np.array([f"PEPTIDE{i % 997}K" for i in range(n)]).astype("S"),
    }
    root = hdf5.Group({"format": "alphadia_tpu_speclib_flat"})
    g = root.create_group("fragment_df", {"n_rows": n, "columns": list(frame)})
    for k, v in frame.items():
        g.create_dataset(k, v)
    hdf5.write(tmp_path / "port.h5", root)
    with h5py.File(tmp_path / "h5py.h5", "w") as f:
        f.attrs["format"] = "alphadia_tpu_speclib_flat"
        hg = f.create_group("fragment_df")
        hg.attrs["n_rows"] = n
        hg.attrs["columns"] = list(frame)
        for k, v in frame.items():
            hg.create_dataset(k, data=v, compression="gzip", compression_opts=1)
    ours, theirs = os.path.getsize(tmp_path / "port.h5"), os.path.getsize(tmp_path / "h5py.h5")
    assert ours <= 1.5 * theirs, (ours, theirs)


# ---------------------------------------------------------------------------
# outside the subset, corrupt files
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# libver="latest", ("v108", "latest") and track_order=True
# ---------------------------------------------------------------------------
NEW_STYLE = {
    "latest": dict(libver="latest"),
    "v108_latest": dict(libver=("v108", "latest")),
    "track_order": dict(track_order=True),
}
NEW_FILTERS = {
    "none": {},
    "gzip_shuffle": dict(compression="gzip", shuffle=True),
    "lzf": dict(compression="lzf"),
    "fletcher32": dict(fletcher32=True),
}


def _census(path) -> dict:
    raw = path.read_bytes()
    return {sig: raw.count(sig.encode()) for sig in ("OHDR", "OCHK", "FRHP", "FHIB", "BTHD", "BTIN", "FAHD", "EASB", "TREE")}


def _implicit(group, name, data, chunk):
    """A chunked dataset of early allocation (the implicit chunk index)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((chunk,))
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    space = h5py.h5s.create_simple(data.shape)
    h5py.h5d.create(group.id, name.encode(), h5py.h5t.py_create(data.dtype), space, dcpl=dcpl).write(
        h5py.h5s.ALL, h5py.h5s.ALL, data
    )


@pytest.mark.parametrize("style", sorted(NEW_STYLE))
def test_port_reads_new_style_groups_and_dense_attributes_as_h5py(tmp_path, style):
    path = tmp_path / "groups.h5"
    track = NEW_STYLE[style].get("track_order", False)
    with h5py.File(path, "w", **NEW_STYLE[style]) as f:
        for i in range(20):
            f.attrs[f"a{i:02d}"] = np.arange(i + 1, dtype=np.int32)
        f.attrs["format"] = "alphadia_tpu_speclib_flat"
        f.attrs["columns"] = ["mz", "intensity", "ä"]
        compact = f.create_group("compact", track_order=track)
        for i in range(9):
            compact.create_dataset(f"d{i}", data=np.arange(i + 1, dtype=np.float32))
        dense = f.create_group("dense", track_order=track)
        for i in (RNG.permutation(200) if track else range(200)):
            d = dense.create_dataset(f"n{i:03d}_{'x' * (i % 17)}", data=np.array([i, -i], dtype=np.int64))
            if i % 50 == 0:
                for k in range(12):
                    d.attrs[f"k{k}"] = f"value {k}"
    got = _port_reads_like_h5py(path)
    assert len([k for k in got if k.startswith("dense/")]) == 200
    census = _census(path)
    if style != "v108_latest":
        assert census["FRHP"] > 0 and census["BTHD"] > 0 and census["BTIN"] > 0, census  # dense links, deep index
    with hdf5.File(path) as f:
        assert list(f["dense"]) == sorted(f["dense"], key=lambda k: k.encode())  # h5py's name order


@pytest.mark.parametrize("style", sorted(NEW_STYLE))
def test_port_reads_every_dtype_in_new_style_files_as_h5py(tmp_path, style):
    """Every dtype of the subset (h5py's ``bool`` enum takes datatype
    version 4 under ``latest``), chunked under gzip and contiguous."""
    path = tmp_path / "dtypes.h5"
    with h5py.File(path, "w", **NEW_STYLE[style]) as f:
        for kind in DTYPES:
            f.create_dataset(kind, **_h5py_data(_column(kind, 700)), compression="gzip")
            f.create_dataset(f"{kind}_contiguous", **_h5py_data(_column(kind, 50)))
            f.attrs[kind] = _column(kind, 3)
    got = _port_reads_like_h5py(path)
    assert got["bool"].dtype == bool and got["vlen"].dtype == object


@pytest.mark.parametrize("filters", sorted(NEW_FILTERS))
@pytest.mark.parametrize("style", sorted(NEW_STYLE))
def test_port_reads_every_chunk_index_as_h5py(tmp_path, style, filters):
    path = tmp_path / "chunks.h5"
    opts = NEW_FILTERS[filters]
    with h5py.File(path, "w", **NEW_STYLE[style]) as f:
        x = RNG.normal(size=3000).astype(np.float32)
        f.create_dataset("single", data=x, chunks=(3000,), **opts)
        f.create_dataset("single_edge", data=x[:2999], chunks=(3000,), maxshape=(3000,), **opts)
        if not opts:
            _implicit(f, "implicit", x, 128)
        f.create_dataset("fixed_paged", data=RNG.integers(-9, 9, 2100).astype(np.int16), chunks=(2,), **opts)
        f.create_dataset("fixed_2d", data=RNG.normal(size=(40, 30)), chunks=(7, 4), **opts)
        f.create_dataset("fixed_spare", data=np.arange(50, dtype=np.uint8), chunks=(8,), maxshape=(100,), **opts)
        f.create_dataset("extensible", data=np.arange(5000, dtype=np.int32), chunks=(4,), maxshape=(None,), **opts)
        f.create_dataset("extensible_2d", data=RNG.normal(size=(300, 6)).astype(np.float32), chunks=(8, 3),
                         maxshape=(None, 6), **opts)
        f.create_dataset("btree2", data=RNG.normal(size=(100, 90)), chunks=(5, 5), maxshape=(None, None), **opts)
        if "shuffle" not in opts and "fletcher32" not in opts:  # HDF5 refuses these on variable-length data
            f.create_dataset("vlen", data=_column("vlen", 700), dtype=h5py.string_dtype(), chunks=(64,), **opts)
        grow = f.create_dataset("grown", shape=(0,), dtype=np.float64, chunks=(16,), maxshape=(None,), **opts)
        grow.resize((1000,))
        grow[::7] = np.arange(143)
    _port_reads_like_h5py(path)
    census = _census(path)
    if style == "latest":
        assert census["FAHD"] > 0 and census["EASB"] > 0 and census["BTIN"] > 0 and census["TREE"] == 0, census
    else:
        assert census["TREE"] > 0, census  # layout 3: the version-1 B-tree chunk index


def test_port_reads_paged_extensible_array_data_blocks_as_h5py(tmp_path):
    """Past 131,072 chunks a super block's data blocks hold more than a page
    (1,024 elements): paged, with a page bitmap in the super block."""
    path = tmp_path / "paged.h5"
    with h5py.File(path, "w", libver="latest") as f:
        d = f.create_dataset("x", shape=(140_000,), dtype=np.uint8, chunks=(1,), maxshape=(None,))
        d[:] = np.arange(140_000) % 251
        sparse = f.create_dataset("sparse", shape=(140_000,), dtype=np.int16, chunks=(1,), maxshape=(None,),
                                  fillvalue=-3)
        sparse[139_000:139_010] = 7  # pages of a paged block left unwritten
    _port_reads_like_h5py(path)


def _write_outside(path, case):
    if case == "soft_link_new_style":
        with h5py.File(path, "w", libver="latest") as f:
            f.create_dataset("y", data=[1])
            f["x"] = h5py.SoftLink("/y")
        return "soft link"
    if case == "external_link":
        with h5py.File(path, "w", libver="latest") as f:
            f["x"] = h5py.ExternalLink("other.h5", "/y")
        return "external"
    if case == "shared_datatype":
        with h5py.File(path, "w", libver="latest") as f:
            f["z_type"] = np.dtype("<f4")  # committed; "x" comes first in name order
            f.create_dataset("x", data=np.arange(3, dtype=np.float32), dtype=f["z_type"])
        return "shared"
    with h5py.File(path, "w") as f:
        if case == "big_endian_int":
            f.create_dataset("x", data=np.arange(5, dtype=">i4"))
            return "big-endian fixed-point"
        if case == "big_endian_float":
            f.create_dataset("x", data=np.arange(5, dtype=">f8"))
            return "big-endian"
        if case == "compound":
            f.create_dataset("x", data=np.zeros(3, dtype=[("a", "<i4"), ("b", "<f8")]))
            return "compound datatype"
        if case == "scaleoffset":
            f.create_dataset("x", data=np.arange(100, dtype=np.int32), scaleoffset=0)
            return "scaleoffset"
        if case == "soft_link":
            f.create_dataset("y", data=[1])
            f["x"] = h5py.SoftLink("/y")
            return "soft link"
        if case == "vlen_sequence":
            f.create_dataset("x", (1,), dtype=h5py.vlen_dtype(np.int32))[0] = np.arange(3, dtype=np.int32)
            return "variable-length sequence"
    raise KeyError(case)


OUTSIDE = ("big_endian_int", "big_endian_float", "compound", "scaleoffset", "soft_link", "vlen_sequence",
           "soft_link_new_style", "external_link", "shared_datatype")


@pytest.mark.parametrize("case", OUTSIDE)
def test_outside_the_subset_raises_naming_it(tmp_path, case):
    path = tmp_path / "x.h5"
    what = _write_outside(path, case)
    with pytest.raises(ValueError, match=what):
        _read(path)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    path = tmp_path_factory.mktemp("corrupt") / "sample.h5"
    with h5py.File(path, "w") as f:
        f.attrs["format"] = "alphadia_tpu_spectra"
        f.create_dataset("mz", data=RNG.normal(size=3000).astype(np.float32), compression="gzip", shuffle=True)
        f.create_dataset("lz", data=np.arange(3000, dtype=np.int32), compression="lzf")
        f.create_dataset("fl", data=np.arange(3000, dtype=np.int16), fletcher32=True, chunks=(500,))
        f.create_dataset("s", data=np.array(["a", "bc"] * 50, dtype=object), dtype=h5py.string_dtype())
        g = f.create_group("g")
        g.attrs["columns"] = ["a", "b"]
    return path.read_bytes()


def _read_all(path):
    with hdf5.File(path) as f:
        dict(f.attrs)
        for k in f:
            node = f[k]
            if isinstance(node, hdf5.Dataset):
                node[()]
            else:
                dict(node.attrs)
                for j in node:
                    node[j]


@pytest.mark.parametrize("cut", [0, 7, 60, 96, 300, 0.25, 0.5, 0.9, -1])
def test_truncated_files_raise(tmp_path, sample, cut):
    n = cut if isinstance(cut, int) and cut >= 0 else int(len(sample) * cut) if cut > 0 else len(sample) - 1
    path = tmp_path / "t.h5"
    path.write_bytes(sample[:n])
    with pytest.raises(ValueError):
        _read_all(path)


def test_flipped_bytes_raise_value_error_or_read(tmp_path, sample):
    """Every flip of one byte either reads or raises ``ValueError``: no
    other exception, no hang."""
    rng = np.random.default_rng(7)
    path = tmp_path / "c.h5"
    raised = 0
    for pos in rng.integers(0, len(sample), 400):
        bad = bytearray(sample)
        bad[pos] ^= int(rng.integers(1, 256))
        path.write_bytes(bytes(bad))
        try:
            _read_all(path)
        except ValueError:
            raised += 1
    assert raised > 0


@pytest.fixture(scope="module")
def latest_sample(tmp_path_factory):
    path = tmp_path_factory.mktemp("corrupt") / "latest.h5"
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(12):
            f.attrs[f"a{i}"] = i
        f.create_dataset("mz", data=RNG.normal(size=3000).astype(np.float32), compression="gzip", shuffle=True,
                         chunks=(2,))
        f.create_dataset("ext", data=np.arange(400, dtype=np.int32), chunks=(4,), maxshape=(None,), fletcher32=True)
        f.create_dataset("bt", data=np.arange(600.0).reshape(30, 20), chunks=(3, 4), maxshape=(None, None))
        g = f.create_group("g")
        for i in range(40):
            g.create_dataset(f"d{i}", data=[i])
        g.attrs["columns"] = ["a", "b"]
    return path.read_bytes()


@pytest.mark.parametrize("cut", [0, 7, 40, 60, 300, 0.25, 0.5, 0.9, -1])
def test_truncated_latest_files_raise(tmp_path, latest_sample, cut):
    sample = latest_sample
    n = cut if isinstance(cut, int) and cut >= 0 else int(len(sample) * cut) if cut > 0 else len(sample) - 1
    path = tmp_path / "t.h5"
    path.write_bytes(sample[:n])
    with pytest.raises(ValueError):
        _read_all(path)


def test_flipped_bytes_of_a_latest_file_raise_value_error_or_read(tmp_path, latest_sample):
    rng = np.random.default_rng(8)
    path = tmp_path / "c.h5"
    raised = 0
    for pos in rng.integers(0, len(latest_sample), 300):
        bad = bytearray(latest_sample)
        bad[pos] ^= int(rng.integers(1, 256))
        path.write_bytes(bytes(bad))
        try:
            _read_all(path)
        except ValueError:
            raised += 1
    assert raised > 0


@pytest.mark.parametrize("sig", ["OHDR", "FRHP", "FHDB", "BTHD", "BTLF", "FAHD", "EAHD", "EAIB"])
def test_a_checksum_mismatch_in_latest_metadata_raises(tmp_path, latest_sample, sig):
    """One byte flipped inside a checksummed block (past its signature):
    the lookup3 checksum names the block."""
    at = latest_sample.index(sig.encode())
    bad = bytearray(latest_sample)
    bad[at + 5] ^= 0x01
    (tmp_path / "bad.h5").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="checksum mismatch|no .* at address|version"):
        _read_all(tmp_path / "bad.h5")


def test_lookup3_against_its_published_values():
    assert hdf5.lookup3(b"") == 0xDEADBEEF
    assert hdf5.lookup3(b"Four score and seven years ago") == 0x17770551
    for n in (1, 11, 12, 13, 24, 25):
        assert hdf5.lookup3(bytes(n)) != hdf5.lookup3(bytes(n + 1))


def test_a_fletcher32_mismatch_raises(tmp_path, sample):
    with h5py.File(tmp_path / "ok.h5", "w") as f:
        f.create_dataset("fl", data=np.arange(3000, dtype=np.int16), fletcher32=True, chunks=(500,))
    raw = bytearray((tmp_path / "ok.h5").read_bytes())
    at = bytes(raw).index(np.arange(1000, 1010, dtype=np.int16).tobytes())
    raw[at] ^= 0x40
    (tmp_path / "bad.h5").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="fletcher32 checksum mismatch"):
        _read(tmp_path / "bad.h5")
    np.testing.assert_array_equal(_read(tmp_path / "ok.h5")["fl"], np.arange(3000, dtype=np.int16))


def test_not_hdf5_raises(tmp_path):
    (tmp_path / "x.h5").write_bytes(b"not an hdf5 file at all" * 50)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        _read(tmp_path / "x.h5")
    (tmp_path / "empty.h5").write_bytes(b"")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        _read(tmp_path / "empty.h5")


def test_fletcher32_and_lzf_helpers():
    """HDF5's Fletcher-32 on words that overflow its 360-word blocks, and an
    LZF stream with overlapping back references, against h5py's own."""
    data = bytes(RNG.integers(0, 256, 100_001, dtype=np.uint8))

    def reference(b):
        if len(b) % 2:
            b += b"\0"
        s1 = s2 = 0
        for (w,) in struct.iter_unpack(">H", b):
            s1 = (s1 + w) % 65535
            s2 = (s2 + s1) % 65535
        return s1, s2

    s1, s2 = reference(data)
    got = hdf5.fletcher32(data)
    assert (got & 0xFFFF) % 65535 == s1 and (got >> 16) % 65535 == s2
    assert hdf5.fletcher32(b"\0" * 10) == 0 and hdf5.fletcher32(b"\xff\xff") == 0x_FFFF_FFFF
    assert hdf5.lzf_decompress(bytes([2]) + b"abc" + bytes([(4 << 5) | 0, 2]), 100) == b"abc" + b"abcabc"
    with pytest.raises(ValueError, match="LZF"):
        hdf5.lzf_decompress(bytes([(1 << 5), 9]), 100)
