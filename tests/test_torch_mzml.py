"""The port's mzML reader (``xml.etree``) against the JAX package's
(``lxml``): every array of the ``SpectrumData`` equal bit for bit, dtypes
included, on

- files of the JAX package's ``testing/mzml_writer.py``, zlib and plain,
  ``.mzML`` and ``.mzML.gz``, and of the port's writer with per-peak
  mobility arrays (each also equal to the spectra written);
- the msconvert-shaped files of ``tests/unit/test_mzml_converter_formats.py``
  (indexed wrapper, chromatograms, second units, per-peak and scan-level
  mobility, numpress arrays, empty and uncompressed 32-bit arrays);
- a profile-mode file (centroided on read);

and the port's MS-Numpress codec against the JAX package's, byte for byte,
on random arrays and on the hand-built cases of ``tests/unit/test_numpress.py``.
"""

import gzip
import importlib.util
import struct
from pathlib import Path

import numpy as np
import pytest

from alphadia_torch.rawdata import load_raw_file
from alphadia_torch.rawdata import numpress as port_np
from alphadia_torch.rawdata.mzml import read_mzml
from alphadia_torch.rawdata.source import SpectrumData
from alphadia_torch.testing.mzml_writer import write_mzml as port_write_mzml
from alphadia_tpu.rawdata import numpress as jax_np
from alphadia_tpu.rawdata.mzml import read_mzml as jax_read_mzml
from alphadia_tpu.testing.mzml_writer import write_mzml as jax_write_mzml
from alphadia_tpu.testing.synthetic import SyntheticConfig, make_synthetic_dia

pytest_plugins = ("torch_port_plugin",)

FIELDS = ("rt", "ms_level", "isolation_lower_mz", "isolation_upper_mz", "peak_start_idx", "peak_stop_idx", "mz", "intensity", "mobility")


def assert_same_spectra(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
        assert np.array_equal(x, y), f


def _converter_module():
    path = Path(__file__).parent / "unit" / "test_mzml_converter_formats.py"
    spec = importlib.util.spec_from_file_location("_converter_formats", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def spectra():
    return {
        mob: make_synthetic_dia(
            SyntheticConfig(n_peptides=40, n_windows=3, n_cycles=30, noise_peaks_per_spectrum=10, with_mobility=mob)
        )[0]
        for mob in (False, True)
    }


@pytest.mark.parametrize("name", ["run.mzML", "run.mzML.gz", "RUN.MZML", "run.mzml.gz"])
@pytest.mark.parametrize("compress", [True, False], ids=["zlib", "plain"])
def test_jax_writer_files(tmp_path, spectra, compress, name):
    """``load_raw_file`` picks the reader by the suffix, in any case."""
    path = tmp_path / "written.mzML"
    jax_write_mzml(path, spectra[False], compress=compress)
    raw = path.read_bytes()
    path = tmp_path / name
    path.write_bytes(gzip.compress(raw) if name.endswith(".gz") else raw)
    ours = load_raw_file(path)
    assert_same_spectra(ours, jax_read_mzml(path))
    assert_same_spectra(ours, spectra[False])


@pytest.mark.parametrize("compress", [True, False], ids=["zlib", "plain"])
def test_port_writer_mobility_files(tmp_path, spectra, compress):
    path = tmp_path / "run4d.mzML"
    port_write_mzml(path, spectra[True], compress=compress)
    ours = read_mzml(path)
    assert ours.has_mobility
    assert_same_spectra(ours, jax_read_mzml(path))
    assert_same_spectra(ours, spectra[True])


def _converter_docs():
    m = _converter_module()
    mz_cv = '<cvParam cvRef="MS" accession="MS:1000514" name="m/z array"/>'
    it_cv = '<cvParam cvRef="MS" accession="MS:1000515" name="intensity array"/>'
    zlib_cv = '<cvParam cvRef="MS" accession="MS:1000574" name="zlib compression"/>'
    mz1 = np.sort(np.random.default_rng(3).uniform(400.0, 1200.0, 64))
    it1 = np.random.default_rng(4).uniform(1.0, 1e6, 64)

    def np_array(payload, acc, kind_cv):
        import base64

        b = base64.b64encode(payload).decode()
        return f'<binaryDataArray><cvParam cvRef="MS" accession="{acc}" name="numpress"/>{kind_cv}<binary>{b}</binary></binaryDataArray>'

    def np_spectrum(idx, mz_arr, it_arr):
        return (
            f'<spectrum index="{idx}" id="scan={idx + 1}" defaultArrayLength="64">'
            '<cvParam cvRef="MS" accession="MS:1000511" name="ms level" value="1"/>'
            '<scanList count="1"><scan><cvParam cvRef="MS" accession="MS:1000016" name="scan start time" '
            f'value="{0.5 + idx / 100}" unitAccession="UO:0000031" unitName="minute"/></scan></scanList>'
            f'<binaryDataArrayList count="2">{mz_arr}{it_arr}</binaryDataArrayList></spectrum>'
        )

    import zlib

    numpress_specs = [
        np_spectrum(0, np_array(jax_np.encode_linear(mz1), "MS:1002312", mz_cv), np_array(jax_np.encode_slof(it1), "MS:1002314", it_cv)),
        np_spectrum(1, np_array(zlib.compress(jax_np.encode_linear(mz1)), "MS:1002746", mz_cv), np_array(jax_np.encode_pic(it1), "MS:1002313", it_cv)),
        np_spectrum(
            2,
            np_array(zlib.compress(jax_np.encode_linear(mz1)), "MS:1002312", zlib_cv + mz_cv),
            np_array(zlib.compress(jax_np.encode_slof(it1)), "MS:1002314", it_cv + zlib_cv),
        ),
    ]
    empty_f32 = (
        '<spectrum index="1" id="scan=2" defaultArrayLength="2">'
        '<cvParam cvRef="MS" accession="MS:1000511" name="ms level" value="1"/>'
        '<scanList count="1"><scan><cvParam cvRef="MS" accession="MS:1000016" name="scan start time" value="0.2" '
        'unitName="minute"/></scan></scanList><binaryDataArrayList count="2">'
        + m._binary_array([100.0, 200.0], "mz", np.float32, False)
        + m._binary_array([5.0, 6.0], "intensity", np.float32, False)
        + "</binaryDataArrayList></spectrum>"
    )
    return {
        "indexed_zlib_f64": m._indexed_mzml(
            [
                m._spectrum(0, 0.5, 1, [400.12, 500.5, 900.9], [100.0, 250.0, 50.0]),
                m._spectrum(1, 0.51, 2, [410.0, 405.0, 600.0], [10.0, 20.0, 30.0], iso=(412.5, 12.5, 12.5)),
            ]
        ),
        "second_units": m._indexed_mzml([m._spectrum(0, 42.0, 1, [500.0], [1.0], rt_unit="second")]),
        "per_peak_mobility": m._indexed_mzml(
            [m._spectrum(0, 1.0, 2, [500.0, 501.0, 502.0], [1.0, 2.0, 3.0], iso=(505.0, 10.0, 10.0), mobility=[1.1, 0.9, 1.0])]
        ),
        "scan_mobility": m._indexed_mzml(
            [
                m._spectrum(0, 1.0, 2, [500.0, 510.0], [1.0, 2.0], iso=(505.0, 10.0, 10.0), scan_mobility=0.85),
                m._spectrum(1, 1.0, 2, [500.0], [3.0], iso=(505.0, 10.0, 10.0), scan_mobility=0.95),
            ]
        ),
        "numpress": m._indexed_mzml([]).replace("</spectrumList>", "".join(numpress_specs) + "</spectrumList>"),
        "empty_and_f32": m._indexed_mzml([m._spectrum(0, 0.1, 1, [], [])]).replace("</spectrumList>", empty_f32 + "</spectrumList>"),
    }


CONVERTER_CASES = ("indexed_zlib_f64", "second_units", "per_peak_mobility", "scan_mobility", "numpress", "empty_and_f32")


@pytest.fixture(scope="module")
def converter_docs():
    return _converter_docs()


@pytest.mark.parametrize("case", CONVERTER_CASES)
def test_converter_files(tmp_path, converter_docs, case):
    path = tmp_path / f"{case}.mzML"
    path.write_bytes(converter_docs[case].encode())
    ours = read_mzml(path)
    assert ours.n_spectra > 0
    assert_same_spectra(ours, jax_read_mzml(path))


def test_profile_mode_file(tmp_path):
    truth_mz = np.array([400.2, 500.5, 500.56])
    grid = np.arange(399.9, 501.0, 0.01)
    trace = sum(h * np.exp(-0.5 * ((grid - m) / 0.015) ** 2) for m, h in zip(truth_mz, (1000.0, 800.0, 600.0)))
    trace[trace < 1.0] = 0.0
    spectra = SpectrumData(
        rt=np.array([10.0, 11.0], np.float32),
        ms_level=np.array([1, 1], np.uint8),
        isolation_lower_mz=np.array([-1.0, -1.0], np.float32),
        isolation_upper_mz=np.array([-1.0, -1.0], np.float32),
        peak_start_idx=np.array([0, len(grid)], np.int64),
        peak_stop_idx=np.array([len(grid), 2 * len(grid)], np.int64),
        mz=np.concatenate([grid, grid]).astype(np.float32),
        intensity=np.concatenate([trace, trace[::-1]]).astype(np.float32),
    )
    path = tmp_path / "profile.mzML"
    jax_write_mzml(path, spectra, profile=True)
    ours = read_mzml(path)
    assert ours.peak_stop_idx[0] - ours.peak_start_idx[0] == 3
    assert_same_spectra(ours, jax_read_mzml(path))


# ---------------------------------------------------------------------------
# MS-Numpress
# ---------------------------------------------------------------------------
def _random_arrays():
    rng = np.random.default_rng(7)
    return {
        "linear": np.sort(rng.uniform(100.0, 1700.0, 5001)),
        "slof": rng.uniform(0.0, 1e7, 4097),
        "pic": np.concatenate([[0, 1, 2**31 - 1], rng.integers(0, 2**31 - 1, 996)]).astype(np.float64),
    }


@pytest.mark.parametrize("codec", ["linear", "slof", "pic"])
def test_numpress_codec_matches_jax(codec):
    values = _random_arrays()[codec]
    encode, decode = getattr(port_np, f"encode_{codec}"), getattr(port_np, f"decode_{codec}")
    data = encode(values)
    assert data == getattr(jax_np, f"encode_{codec}")(values)
    ours = decode(data)
    theirs = getattr(jax_np, f"decode_{codec}")(data)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


HAND_BUILT = {
    "pic": ("pic", bytes([0x73, 0x7A, 0x80])),
    "linear": ("linear", struct.pack(">d", 100.0) + struct.pack("<I", 500) + struct.pack("<I", 550) + bytes([0x86, 0x23])),
    "linear_negative_diff": ("linear", struct.pack(">d", 10.0) + struct.pack("<I", 10) + struct.pack("<I", 30) + bytes([0xF6])),
    "slof": ("slof", struct.pack(">d", 1000.0) + np.array([0, 6908], "<u2").tobytes()),
    "linear_negative_seeds": ("linear", jax_np.encode_linear(np.array([-5.0, -4.25, -3.5, -1.0, 0.0, 2.5, 7.0]), fixed_point=1000.0)),
    "linear_tiny": ("linear", jax_np.encode_linear([42.0], fixed_point=1000.0)),
}


@pytest.mark.parametrize("case", sorted(HAND_BUILT))
def test_numpress_hand_built_bytes_match_jax(case):
    codec, data = HAND_BUILT[case]
    ours = getattr(port_np, f"decode_{codec}")(data)
    theirs = getattr(jax_np, f"decode_{codec}")(data)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def test_numpress_truncated_stream_raises_in_both():
    data = struct.pack(">d", 100.0) + struct.pack("<I", 1) + struct.pack("<I", 2) + bytes([0x10])
    for decode in (port_np.decode_linear, jax_np.decode_linear):
        with pytest.raises(ValueError, match="truncated|corrupt"):
            decode(data)
