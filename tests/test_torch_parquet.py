"""The port's Parquet writer and reader (``alphadia_torch/utils/parquet.py``)
against pyarrow.

- A PSM-like frame of every dtype the per-run psm and fragment frames carry
  (uint8, uint32, int64, float32, float64 with NaN, text) and of the other
  dtypes the writer takes (bool, int8, int16, int32, uint16, uint64), as
  the port writes it: pyarrow reads every column back with its dtype and
  its values (NaN as a null, as pandas writes it), and so does the port's
  reader.
- Files pyarrow writes from pandas with ``compression=None,
  use_dictionary=False`` (several data pages a column, nulls), and with
  pandas' defaults (Snappy, dictionary pages), as the JAX package writes
  its per-run files: the port's reader gives pandas' values and dtypes; a
  codec it does not read (gzip) is refused.
- Edge cases: an empty frame, empty and non-ASCII strings.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from alphadia_torch.utils.parquet import read_parquet, write_parquet

pytest_plugins = ("torch_port_plugin",)

ARROW_TYPES = {
    "b1": pa.bool_(), "i1": pa.int8(), "i2": pa.int16(), "i4": pa.int32(), "i8": pa.int64(), "u1": pa.uint8(),
    "u2": pa.uint16(), "u4": pa.uint32(), "u8": pa.uint64(), "f4": pa.float32(), "f8": pa.float64(),
}


def psm_like(n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    words = ["PEPTIDEK", "", "ÄÖÜ-é", "β-κ;γ", "x" * 300, "PROT1;PROT2"]
    frame = {
        "precursor_idx": rng.integers(0, 2**32, n).astype(np.uint32),
        "rank": rng.integers(0, 5, n).astype(np.uint8),
        "decoy": rng.integers(0, 2, n).astype(np.uint8),
        "frame_center": rng.integers(-(2**40), 2**40, n),
        "score": rng.normal(size=n).astype(np.float32),
        "qval": rng.random(n),
        "proba": rng.random(n),
        "sequence": np.array([words[i % len(words)] for i in range(n)], dtype=object),
        "flag": rng.random(n) > 0.5,
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "i16": rng.integers(-(2**15), 2**15, n).astype(np.int16),
        "i32": rng.integers(-(2**31), 2**31, n).astype(np.int32),
        "u16": rng.integers(0, 2**16, n).astype(np.uint16),
        "u64": rng.integers(0, 2**63, n).astype(np.uint64) * np.uint64(2) + np.uint64(1),
        "fixed_text": np.array(["ab"] * n, dtype="<U2"),
    }
    if n:
        frame["proba"][:: 7] = np.nan
        frame["score"][n // 2] = np.nan
    return frame


def assert_frames_equal(ours: dict, expected: dict):
    assert list(ours) == list(expected)
    for k, v in expected.items():
        got = ours[k]
        if v.dtype.kind in "OU":
            assert got.dtype == object and list(got) == list(v), k
        else:
            assert got.dtype == v.dtype, (k, got.dtype, v.dtype)
            assert np.array_equal(got, v, equal_nan=v.dtype.kind == "f"), k


@pytest.mark.parametrize("n", [0, 1, 9, 5000])
def test_pyarrow_reads_what_the_port_writes(tmp_path, n):
    frame = psm_like(n)
    path = tmp_path / "psm.parquet"
    write_parquet(frame, path)
    table = pq.read_table(path)
    assert table.num_rows == n
    for k, v in frame.items():
        field = table.schema.field(k)
        if v.dtype.kind in "OU":
            assert field.type == pa.string(), k
            assert table.column(k).to_pylist() == list(v), k
            continue
        assert field.type == ARROW_TYPES[v.dtype.str[1:]], (k, field.type)
        col = table.column(k)
        if v.dtype.kind == "f":
            assert col.null_count == int(np.isnan(v).sum()), k
        got = table.to_pandas()[k].to_numpy()
        assert got.dtype == v.dtype and np.array_equal(got, v, equal_nan=v.dtype.kind == "f"), k
    assert_frames_equal(read_parquet(path), frame)


@pytest.mark.parametrize("page_size", [1 << 20, 512], ids=["one_page", "many_pages"])
@pytest.mark.parametrize("n", [0, 3, 4000])
def test_port_reads_what_pyarrow_writes(tmp_path, n, page_size):
    frame = psm_like(n, seed=1)
    path = tmp_path / "psm.parquet"
    pd.DataFrame(frame).to_parquet(path, index=False, compression=None, use_dictionary=False, data_page_size=page_size)
    ours = read_parquet(path)
    theirs = pd.read_parquet(path)
    assert list(ours) == list(theirs.columns)
    for k in theirs.columns:
        t = theirs[k].to_numpy()
        if t.dtype == object or ours[k].dtype == object:
            assert list(ours[k]) == list(t), k
        else:
            assert ours[k].dtype == t.dtype and np.array_equal(ours[k], t, equal_nan=t.dtype.kind == "f"), k
    assert_frames_equal(ours, frame)


def test_round_trip_keeps_text_with_nulls(tmp_path):
    frame = {"text": np.array(["a", None, "", "é", None], dtype=object), "x": np.arange(5, dtype=np.int64)}
    path = tmp_path / "nulls.parquet"
    write_parquet(frame, path)
    assert pq.read_table(path).column("text").to_pylist() == ["a", None, "", "é", None]
    back = read_parquet(path)
    assert list(back["text"]) == ["a", None, "", "é", None]
    assert np.array_equal(back["x"], frame["x"])


def test_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(TypeError):
        write_parquet({"c": np.zeros(2, np.complex64)}, tmp_path / "c.parquet")
    with pytest.raises(TypeError):
        write_parquet({"o": np.array([1, "a"], dtype=object)}, tmp_path / "o.parquet")
    with pytest.raises(ValueError):
        write_parquet({"a": np.zeros(2), "b": np.zeros(3)}, tmp_path / "l.parquet")


@pytest.mark.parametrize("compression,dictionary", [("snappy", True), (None, True), ("snappy", False)])
@pytest.mark.parametrize("n", [3, 4000])
def test_port_reads_pyarrow_defaults(tmp_path, n, compression, dictionary):
    frame = psm_like(n, seed=2)
    path = tmp_path / "psm.parquet"
    pd.DataFrame(frame).to_parquet(path, index=False, compression=compression, use_dictionary=dictionary,
                                   data_page_size=2048)
    ours = read_parquet(path)
    theirs = pd.read_parquet(path)
    assert list(ours) == list(theirs.columns)
    for k in theirs.columns:
        t = theirs[k].to_numpy()
        if t.dtype == object or ours[k].dtype == object:
            assert list(ours[k]) == list(t), k
        else:
            assert ours[k].dtype == t.dtype and np.array_equal(ours[k], t, equal_nan=t.dtype.kind == "f"), k
    assert_frames_equal(ours, frame)


def test_refuses_compressed_files(tmp_path):
    path = tmp_path / "gzip.parquet"
    pd.DataFrame({"a": np.arange(10)}).to_parquet(path, compression="gzip", use_dictionary=False)
    with pytest.raises(ValueError, match="compression codec"):
        read_parquet(path)
