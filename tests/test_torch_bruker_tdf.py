"""The port's Bruker TDF reader (``alphadia_torch/rawdata/bruker_tdf.py``,
frames through the port's zstd decoder) against the JAX package's, on the
CPU.

- The cases of ``tests/unit/test_bruker_tdf.py`` against the port.
- The JAX and the port's ``read_bruker_d`` on one ``.d``, every array equal
  bit for bit: the ``.d`` written by the JAX writer (zstd level 3), by the
  port's writer (raw and RLE blocks, with and without checksums) and by the
  port's writer with diaPASEF window groups of several windows a frame.
- The committed fixture (``alphadia_torch/testing/data/tdf_world.d``)
  against the sha256 of the JAX reader's arrays it records.
- The port's writer against the input quantized through the converters;
  corrupt and truncated ``.d`` directories raise ``TdfFormatError``.
- The CLI from a small 4D ``.d`` with a TSV library, both packages: the IDs
  at 1% FDR and the protein groups overlap by Jaccard >= 0.95.

As a script (``PYTHONPATH=.:tests python tests/test_torch_bruker_tdf.py
--random-state 0 1 2 3 4 5 [--packages jax port]``) it prints the JAX readings that phase
[11c] of ``chip_smoke.py`` gates on.
"""

import json
import logging
import sqlite3

import numpy as np
import pandas as pd
import pytest

import alphadia_torch.cli as port_cli
import alphadia_tpu.cli as jax_cli
from alphadia_torch.rawdata import load_raw_file
from alphadia_torch.rawdata import bruker_tdf as port
from alphadia_torch.testing import tdf_writer as port_writer
from alphadia_tpu.rawdata import bruker_tdf as ref
from alphadia_tpu.testing import tdf_writer as ref_writer
from torch_tdf_fixture import DATA, array_sha256
from torch_workflow_worlds import WORLDS, d_readings, same_spectra, tdf_quantized, write_d_inputs

pytest_plugins = ("torch_port_plugin",)

JACCARD_MIN = 0.95


# ---------------------------------------------------------------------------
# the cases of tests/unit/test_bruker_tdf.py
# ---------------------------------------------------------------------------
def test_decode_frame_blob_golden():
    # 2 scans: scan0 peaks (tof 5, int 100), (tof 7, int 50); scan1 (tof 3, int 10)
    blob = np.asarray([2, 4, 6, 100, 2, 50, 4, 10], dtype=np.uint32)
    scan, tof, inten = port._decode_frame_blob(blob)
    np.testing.assert_array_equal(scan, [0, 0, 1])
    np.testing.assert_array_equal(tof, [5, 7, 3])
    np.testing.assert_array_equal(inten, [100, 50, 10])


def test_decode_empty_scans():
    blob = np.asarray([4, 0, 0, 2, 1, 9], dtype=np.uint32)
    scan, tof, inten = port._decode_frame_blob(blob)
    np.testing.assert_array_equal(scan, [2])
    np.testing.assert_array_equal(tof, [0])
    np.testing.assert_array_equal(inten, [9])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_encode_decode_random_frames(writer):
    """Frames of either writer through the port's decoder, unshuffle and
    blob decode give the peaks back; the port's blob equals JAX's after
    decompression."""
    from alphadia_torch.rawdata import zstd

    rng = np.random.default_rng(7)
    for _ in range(5):
        n_scans = int(rng.integers(1, 40))
        scans, expect = [], []
        for s in range(n_scans):
            n = int(rng.integers(0, 30))
            tofs = np.sort(rng.choice(5000, size=n, replace=False)).astype(np.int64)
            ints = rng.integers(1, 2**16, size=n)
            scans.append((tofs, ints))
            expect.extend((s, t, v) for t, v in zip(tofs, ints))
        blob = (ref_writer if writer == "jax" else port_writer).encode_frame(scans)
        payload = zstd.decompress(blob[8:])
        import zstandard

        assert payload == zstandard.ZstdDecompressor().decompress(ref_writer.encode_frame(scans)[8:])
        scan, tof, inten = port._decode_frame_blob(port._unshuffle_u32(payload))
        assert list(zip(scan.tolist(), tof.tolist(), inten.tolist())) == expect
        assert int.from_bytes(blob[:4], "little") == len(blob) and int.from_bytes(blob[4:8], "little") == n_scans
        # the same frame behind another in one buffer, read at its offset
        buf = memoryview(ref_writer.encode_frame(scans[:1]) + blob)
        got = port._read_frame(buf, len(buf) - len(blob), len(payload))
        assert all(np.array_equal(a, b) for a, b in zip(got, (scan, tof, inten)))
        with pytest.raises(port.TdfFormatError, match="overruns"):
            port._read_frame(buf[:-1], len(buf) - len(blob))


def test_converters_round_trip():
    mz_conv = port.TofMzConverter(100.0, 1700.0, 400_000)
    mz = np.asarray([100.0, 523.7, 1699.9])
    np.testing.assert_allclose(mz_conv(mz_conv.invert(mz)), mz, rtol=1e-5)
    im_conv = port.ScanImConverter(0.6, 1.5, 900)
    assert im_conv(np.asarray([0]))[0] == pytest.approx(1.5)
    assert im_conv(np.asarray([900]))[0] == pytest.approx(0.6)
    ref_mz, ref_im = ref.TofMzConverter(100.0, 1700.0, 400_000), ref.ScanImConverter(0.6, 1.5, 900)
    tof = np.arange(0, 400_000, 997, dtype=np.uint32)
    np.testing.assert_array_equal(mz_conv(tof), ref_mz(tof))
    np.testing.assert_array_equal(mz_conv.invert(mz_conv(tof)), ref_mz.invert(ref_mz(tof)))
    np.testing.assert_array_equal(im_conv(np.arange(901)), ref_im(np.arange(901)))


def _frame_scans(peaks, n_scans):
    out = []
    for s in range(n_scans):
        mine = sorted((t, v) for sc, t, v in peaks if sc == s)
        out.append((np.asarray([t for t, _ in mine], dtype=np.int64), np.asarray([v for _, v in mine], dtype=np.int64)))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_read_bruker_d_round_trip(tmp_path, writer):
    mz_range, tof_max, im_range, n_scans = (100.0, 1000.0), 200_000, (0.6, 1.5), 10
    mz_conv = port.TofMzConverter(*mz_range, tof_max)
    im_conv = port.ScanImConverter(*im_range, n_scans)
    ms1_peaks = [(2, 1000, 55), (2, 40_000, 22), (7, 1000, 11)]
    dia_peaks = [(1, 500, 9), (4, 90_000, 77), (8, 123_456, 5)]
    frames = [
        {"time": 1.0, "msms_type": 0, "scans": _frame_scans(ms1_peaks, n_scans)},
        {"time": 1.1, "msms_type": 9, "window_group": 1, "scans": _frame_scans(dia_peaks, n_scans)},
    ]
    dia_windows = {1: [(0, 5, 450.0, 25.0), (5, 10, 650.0, 25.0)]}
    d_dir = (ref_writer if writer == "jax" else port_writer).write_tdf(
        tmp_path / "run.d", frames, dia_windows=dia_windows, mz_range=mz_range, tof_max_index=tof_max, im_range=im_range,
    )
    data = port.read_bruker_d(d_dir)
    assert data.n_spectra == 3
    np.testing.assert_array_equal(data.ms_level, [1, 2, 2])
    np.testing.assert_allclose(data.rt, [1.0, 1.1, 1.1])
    np.testing.assert_allclose(data.isolation_lower_mz, [-1.0, 437.5, 637.5])
    np.testing.assert_allclose(data.isolation_upper_mz, [-1.0, 462.5, 662.5])
    assert data.has_mobility

    def spectrum(i):
        a, b = data.peak_start_idx[i], data.peak_stop_idx[i]
        return data.mz[a:b], data.intensity[a:b], data.mobility[a:b]

    mz0, int0, mob0 = spectrum(0)
    exp = sorted((float(mz_conv(np.asarray([t]))[0]), s, v, float(im_conv(np.asarray([s]))[0])) for s, t, v in ms1_peaks)
    np.testing.assert_allclose(mz0, [e[0] for e in exp], rtol=1e-6)
    np.testing.assert_allclose(int0, [e[2] for e in exp])
    np.testing.assert_allclose(mob0, [e[3] for e in exp], rtol=1e-6)
    mz1, int1, _ = spectrum(1)
    assert len(mz1) == 2
    np.testing.assert_allclose(int1, [9, 77])
    mz2, int2, _ = spectrum(2)
    np.testing.assert_allclose(int2, [5])
    np.testing.assert_allclose(mz2, mz_conv(np.asarray([123_456])), rtol=1e-6)
    assert same_spectra(data, ref.read_bruker_d(d_dir))


def test_unsupported_compression(tmp_path):
    d_dir = port_writer.write_tdf(
        tmp_path / "bad.d", [{"time": 0.0, "msms_type": 0, "scans": [(np.asarray([1]), np.asarray([1]))]}]
    )
    con = sqlite3.connect(d_dir / "analysis.tdf")
    con.execute("UPDATE GlobalMetadata SET Value='1' WHERE Key='TimsCompressionType'")
    con.commit()
    con.close()
    with pytest.raises(port.TdfFormatError, match="TimsCompressionType"):
        port.read_bruker_d(d_dir)


def test_not_a_tdf_dir(tmp_path):
    with pytest.raises(port.TdfFormatError, match="not a TDF"):
        port.read_bruker_d(tmp_path)


# ---------------------------------------------------------------------------
# the port's reader against JAX's on whole runs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world():
    from alphadia_torch.testing.synthetic import SyntheticConfig, make_synthetic_dia

    spectra, _, _ = make_synthetic_dia(
        SyntheticConfig(n_peptides=400, n_windows=6, n_cycles=60, with_mobility=True, seed=13, from_sequence=True)
    )
    return spectra


WRITERS = {
    "jax_writer_zstd3": lambda s, p: ref_writer.spectrum_data_to_tdf(s, p),
    "port_writer": lambda s, p: port_writer.spectrum_data_to_tdf(s, p),
    "port_writer_checksum": lambda s, p: port_writer.spectrum_data_to_tdf(s, p, checksum=True),
    "port_writer_window_groups": lambda s, p: port_writer.spectrum_data_to_tdf(s, p, windows_per_frame=3),
}


@pytest.mark.parametrize("how", sorted(WRITERS))
def test_port_reads_what_jax_reads(tmp_path, world, how):
    d_dir = WRITERS[how](world, tmp_path / "run.d")
    want = ref.read_bruker_d(d_dir)
    for threads in (1, 4):
        assert same_spectra(port.read_bruker_d(d_dir, thread_count=threads), want)
    assert same_spectra(load_raw_file(d_dir), want)
    if how == "port_writer_window_groups":
        # two DIA frames a cycle of six windows: three windows a frame
        con = sqlite3.connect(d_dir / "analysis.tdf")
        groups = con.execute("SELECT WindowGroup, COUNT(*) FROM DiaFrameMsMsWindows GROUP BY WindowGroup").fetchall()
        con.close()
        assert len(groups) == 2 and all(n == 3 for _, n in groups)
        assert want.n_spectra == world.n_spectra


@pytest.mark.parametrize("batch_bytes", [1, 5000])
def test_frames_decoded_in_batches_read_the_same(tmp_path, world, monkeypatch, batch_bytes):
    """Batches bounded by decoded bytes (one frame a batch, or a few) give
    the arrays of one batch for the whole run, in as many batch calls as the
    payload's sum over ``DECODE_BATCH_BYTES``."""
    d_dir = port_writer.spectrum_data_to_tdf(world, tmp_path / "run.d", windows_per_frame=3)
    want = port.read_bruker_d(d_dir, thread_count=2)
    sizes = [4 * (n_scans + 2 * n_peaks) for _, _, n_scans, n_peaks in _frames_table(d_dir)]
    calls = []
    decompress_frames = port.zstd.decompress_frames
    monkeypatch.setattr(port, "DECODE_BATCH_BYTES", batch_bytes)
    monkeypatch.setattr(port.zstd, "decompress_frames", lambda *a, **k: calls.append(1) or decompress_frames(*a, **k))
    assert same_spectra(port.read_bruker_d(d_dir, thread_count=2), want)
    assert len(calls) == len(set(np.cumsum(sizes) // batch_bytes)) > 1
    assert batch_bytes > 1 or len(calls) == len(sizes)


def test_port_writer_round_trip_is_the_quantized_input(tmp_path, world):
    port_writer.spectrum_data_to_tdf(world, tmp_path / "run.d")
    expected, worst_ppm, worst_im, outside = tdf_quantized(world)
    assert same_spectra(port.read_bruker_d(tmp_path / "run.d"), expected)
    assert worst_ppm < 2.5 and worst_im <= 1.1 / 927 / 2 + 1e-6


def test_committed_fixture_matches_the_jax_reading():
    """``tdf_world.d`` (JAX writer, zstd level 3) read by the port: the
    sha256 of every array equals that of the JAX reader's, recorded when the
    fixture was made."""
    rec = json.loads((DATA / "tdf_fixture.json").read_text())
    data = port.read_bruker_d(DATA / "tdf_world.d")
    assert array_sha256(data) == rec["read_bruker_d_sha256"]
    assert len(data.mz) <= rec["n_peaks"]
    assert array_sha256(ref.read_bruker_d(DATA / "tdf_world.d")) == rec["read_bruker_d_sha256"]


def test_skipped_frames_warn_as_jax(tmp_path, caplog):
    frames = [
        {"time": 0.0, "msms_type": 0, "scans": _frame_scans([(1, 10, 5)], 4)},
        {"time": 0.5, "msms_type": 8, "scans": _frame_scans([(2, 20, 6)], 4)},
        {"time": 1.0, "msms_type": 9, "window_group": 1, "scans": _frame_scans([(3, 30, 7)], 4)},
        {"time": 1.5, "msms_type": 9, "window_group": 1, "scans": _frame_scans([(0, 40, 8)], 4)},
    ]
    d_dir = port_writer.write_tdf(tmp_path / "run.d", frames, dia_windows={1: [(0, 4, 500.0, 20.0)]})
    con = sqlite3.connect(d_dir / "analysis.tdf")
    con.execute("DELETE FROM DiaFrameMsMsInfo WHERE Frame = 4")
    con.commit()
    con.close()
    with caplog.at_level(logging.WARNING):
        got = port.read_bruker_d(d_dir)
    assert same_spectra(got, ref.read_bruker_d(d_dir))
    assert got.n_spectra == 2
    text = caplog.text
    assert "skipped 1 MsMsType=8 frames" in text and "skipped 1 MsMsType=9 frames" in text


# ---------------------------------------------------------------------------
# malformed .d directories raise TdfFormatError
# ---------------------------------------------------------------------------
@pytest.fixture()
def small_d(tmp_path, world):
    return port_writer.spectrum_data_to_tdf(world, tmp_path / "run.d", checksum=True)


def _frames_table(d_dir):
    con = sqlite3.connect(d_dir / "analysis.tdf")
    rows = con.execute("SELECT Id, TimsId, NumScans, NumPeaks FROM Frames ORDER BY Id").fetchall()
    con.close()
    return rows


def _sql(d_dir, statement):
    con = sqlite3.connect(d_dir / "analysis.tdf")
    con.execute(statement)
    con.commit()
    con.close()


def test_truncated_tdf_bin_raises(small_d):
    data = (small_d / "analysis.tdf_bin").read_bytes()
    for keep in (0, 5, len(data) // 2, len(data) - 1):
        (small_d / "analysis.tdf_bin").write_bytes(data[:keep])
        with pytest.raises(port.TdfFormatError, match="overruns tdf_bin" if keep else "is empty"):
            port.read_bruker_d(small_d)


def test_flipped_bytes_in_a_frame_raise(small_d):
    data = bytearray((small_d / "analysis.tdf_bin").read_bytes())
    _, off, _, _ = _frames_table(small_d)[3]
    rng = np.random.default_rng(0)
    n = int.from_bytes(data[off : off + 4], "little")
    for pos in rng.choice(np.arange(off + 8, off + n), size=40, replace=False):
        bad = bytearray(data)
        bad[pos] ^= 0x5A
        (small_d / "analysis.tdf_bin").write_bytes(bytes(bad))
        with pytest.raises(port.TdfFormatError, match="frame 4"):
            port.read_bruker_d(small_d)


def test_frames_table_disagreeing_with_the_frame_raises(small_d):
    fid, off, _, n_peaks = _frames_table(small_d)[2]
    _sql(small_d, f"UPDATE Frames SET NumPeaks = {n_peaks + 1} WHERE Id = {fid}")
    with pytest.raises(port.TdfFormatError, match=rf"frame {fid} at offset {off}: decoded \d+ bytes, expected \d+"):
        port.read_bruker_d(small_d)
    _sql(small_d, f"UPDATE Frames SET NumPeaks = {n_peaks - 1} WHERE Id = {fid}")
    with pytest.raises(port.TdfFormatError, match=f"frame {fid} at offset {off}: decoded content larger than expected"):
        port.read_bruker_d(small_d)
    _sql(small_d, f"UPDATE Frames SET NumPeaks = -{n_peaks} WHERE Id = {fid}")
    with pytest.raises(port.TdfFormatError, match=f"frame {fid}: implausible NumScans"):
        port.read_bruker_d(small_d)
    _sql(small_d, f"UPDATE Frames SET NumPeaks = {n_peaks}, TimsId = 1000000000000 WHERE Id = {fid}")
    with pytest.raises(port.TdfFormatError, match="overruns tdf_bin"):
        port.read_bruker_d(small_d)


def test_frames_without_content_size_are_sized_from_the_table(tmp_path):
    """A frame without ``Frame_Content_Size`` (python-zstandard's stream
    mode) reads as the same frame with one; where its ``Frames`` row is
    wrong it fails on the decoded size; a row without NumPeaks is decoded
    unsized."""
    import zstandard

    scans = _frame_scans([(0, 5, 3), (1, 9, 4)], 3)
    d_dir = port_writer.write_tdf(tmp_path / "run.d", [{"time": 0.0, "msms_type": 0, "scans": scans}])
    want = ref.read_bruker_d(d_dir)  # python-zstandard refuses frames without a content size
    blob = port_writer.encode_frame(scans)
    payload = zstandard.ZstdDecompressor().decompress(blob[8:])
    cobj = zstandard.ZstdCompressor(level=3).compressobj()
    comp = cobj.compress(payload) + cobj.flush()
    (d_dir / "analysis.tdf_bin").write_bytes((len(comp) + 8).to_bytes(4, "little") + (3).to_bytes(4, "little") + comp)
    assert same_spectra(port.read_bruker_d(d_dir), want)
    _sql(d_dir, "UPDATE Frames SET NumPeaks = 3")
    with pytest.raises(port.TdfFormatError, match="frame 1 at offset 0: decoded 28 bytes, expected 36"):
        port.read_bruker_d(d_dir)
    _sql(d_dir, "UPDATE Frames SET NumPeaks = NULL")
    assert same_spectra(port.read_bruker_d(d_dir), want)


def test_missing_d_raises_through_load_raw_file(tmp_path):
    with pytest.raises(port.TdfFormatError, match="not a TDF .d directory"):
        load_raw_file(tmp_path / "run.d")


# ---------------------------------------------------------------------------
# the CLI from a .d, both packages
# ---------------------------------------------------------------------------
def _exit_code(run, argv) -> int:
    try:
        run(argv)
    except SystemExit as e:
        return e.code
    return 0


CLI_D_WORLD = dict(n_peptides=300, n_windows=6, n_cycles=300, seed=23, with_mobility=True, from_sequence=True)


@pytest.fixture(scope="module")
def cli_from_d(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_d")
    d_path, lib, truth, cycle_rt, _ = write_d_inputs(tmp, CLI_D_WORLD)
    out = {}
    config = json.dumps(WORLDS["4d"]["config"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALPHADIA_TORCH_DEVICE", "cpu")
        for who, run in (("jax", jax_cli.run), ("port", port_cli.run)):
            argv = ["-o", str(tmp / who), "-f", str(d_path), "-l", str(lib), "--config-dict", config]
            assert _exit_code(run, argv) == 0, who
            out[who] = tmp / who
    return out, truth, cycle_rt


def _ids(psm: pd.DataFrame) -> set:
    sel = psm[(psm["precursor.qval"] <= 0.01) & (psm["precursor.decoy"] == 0)]
    return set(zip(sel["precursor.sequence"], sel["precursor.charge"]))


def _jaccard(a: set, b: set) -> float:
    return len(a & b) / max(len(a | b), 1)


def test_cli_from_d_matches_jax(cli_from_d):
    out, truth, cycle_rt = cli_from_d
    want, got = (pd.read_parquet(out[w] / "precursors.parquet") for w in ("jax", "port"))
    assert list(got.columns) == list(want.columns)
    a, b = _ids(want), _ids(got)
    assert len(a) > 150
    assert _jaccard(a, b) >= JACCARD_MIN
    assert _jaccard(set(want["pg.name"]), set(got["pg.name"])) >= JACCARD_MIN
    r_jax, r_port = (d_readings(out[w], truth, cycle_rt) for w in ("jax", "port"))
    assert r_port["mobility_error_median"] < 0.03 and r_jax["mobility_error_median"] < 0.03
    assert (out["port"] / "quant" / "run_4d" / "psm.parquet").exists()


def main():
    """The JAX CLI (or with ``--packages`` the port's too, on the CPU) on the 4D
    quarter world as a ``.d`` of the port's writer: one JSON line of
    ``d_readings`` a package and random state, the readings phase [11c] of
    ``chip_smoke.py`` gates on."""
    import argparse
    import hashlib
    import os
    import tempfile
    from pathlib import Path

    from torch_workflow_worlds import D_BATCH, d_sha256

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--random-state", type=int, nargs="+", default=[0])
    ap.add_argument("--packages", nargs="+", choices=("jax", "port"), default=["jax"],
                    help="whose CLI to run (the port's on the CPU)")
    opt = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        d_path, lib, truth, cycle_rt, _ = write_d_inputs(tmp)
        print(json.dumps({"d_sha256": d_sha256(d_path), "lib_sha256": hashlib.sha256(lib.read_bytes()).hexdigest()}), flush=True)
        os.environ["ALPHADIA_TORCH_DEVICE"] = "cpu"
        for state in opt.random_state:
            for who in opt.packages:
                run = {"jax": jax_cli.run, "port": port_cli.run}[who]
                out = tmp / f"{who}_{state}"
                argv = ["-o", str(out), "-f", str(d_path), "-l", str(lib), "--config-dict", json.dumps(
                    {"general": {"random_state": state, "save_figures": False}, "calibration": {"batch_size": D_BATCH}})]
                code = _exit_code(run, argv)
                print(json.dumps({"who": who, "random_state": state, "exit": code,
                                  **(d_readings(out, truth, cycle_rt) if code == 0 else {})}), flush=True)


if __name__ == "__main__":
    main()
