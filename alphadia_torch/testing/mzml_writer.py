"""Minimal standard-conforming mzML writer (tests and interchange).

The JAX package's ``testing/mzml_writer.py``, which also writes the
per-peak mobility array (``MS:1002816``, 32-bit) of ion-mobility data, so
that ``rawdata.mzml.read_mzml`` gives back every array of a
``SpectrumData`` bit for bit: m/z as 64-bit floats, intensity and mobility
as 32-bit, RT in minutes and the isolation window as target and offsets
(each read back within a float64 rounding of the float32 value).
"""

from __future__ import annotations

import base64
import zlib
from pathlib import Path

import numpy as np

from alphadia_torch.rawdata.source import SpectrumData

_NS = "http://psi.hupo.org/ms/mzml"


def _b64(arr, dtype, compress=True) -> str:
    raw = np.asarray(arr, dtype=dtype).tobytes()
    if compress:
        raw = zlib.compress(raw)
    return base64.b64encode(raw).decode()


def write_mzml(
    path: str | Path,
    spectra: SpectrumData,
    compress: bool = True,
    profile: bool = False,
) -> None:
    """``profile=True`` marks every spectrum as profile mode (MS:1000128):
    the peaks are written as they are, so pass profile traces. Spectra with
    mobility get their per-peak mobility array."""
    comp_acc = (
        '<cvParam accession="MS:1000574" name="zlib compression" value=""/>'
        if compress
        else '<cvParam accession="MS:1000576" name="no compression" value=""/>'
    )
    mode_acc = '<cvParam accession="MS:1000128" name="profile spectrum" value=""/>' if profile else ""
    with open(path, "w") as out:
        out.write(f'<?xml version="1.0" encoding="utf-8"?>\n<mzML xmlns="{_NS}"><run><spectrumList>')
        for i in range(spectra.n_spectra):
            a, b = spectra.peak_start_idx[i], spectra.peak_stop_idx[i]
            lvl = int(spectra.ms_level[i])
            rt_min = float(spectra.rt[i]) / 60.0
            prec = ""
            if lvl == 2:
                lo = float(spectra.isolation_lower_mz[i])
                hi = float(spectra.isolation_upper_mz[i])
                target = (lo + hi) / 2
                prec = (
                    "<precursorList><precursor><isolationWindow>"
                    f'<cvParam accession="MS:1000827" name="isolation window target m/z" value="{target}"/>'
                    f'<cvParam accession="MS:1000828" name="isolation window lower offset" value="{target - lo}"/>'
                    f'<cvParam accession="MS:1000829" name="isolation window upper offset" value="{hi - target}"/>'
                    "</isolationWindow></precursor></precursorList>"
                )
            mob = ""
            if spectra.has_mobility:
                mob = (
                    '<binaryDataArray><cvParam accession="MS:1002816" '
                    'name="mean inverse reduced ion mobility array" value=""/>'
                    f'<cvParam accession="MS:1000521" name="32-bit float" value=""/>{comp_acc}'
                    f"<binary>{_b64(spectra.mobility[a:b], np.float32, compress)}</binary></binaryDataArray>"
                )
            out.write(
                f'<spectrum index="{i}" id="scan={i}" defaultArrayLength="{b - a}">'
                f'<cvParam accession="MS:1000511" name="ms level" value="{lvl}"/>'
                f"{mode_acc}"
                "<scanList><scan>"
                f'<cvParam accession="MS:1000016" name="scan start time" value="{rt_min}" unitName="minute"/>'
                "</scan></scanList>"
                f"{prec}"
                "<binaryDataArrayList>"
                '<binaryDataArray><cvParam accession="MS:1000514" name="m/z array" value=""/>'
                f'<cvParam accession="MS:1000523" name="64-bit float" value=""/>{comp_acc}'
                f"<binary>{_b64(spectra.mz[a:b], np.float64, compress)}</binary></binaryDataArray>"
                '<binaryDataArray><cvParam accession="MS:1000515" name="intensity array" value=""/>'
                f'<cvParam accession="MS:1000521" name="32-bit float" value=""/>{comp_acc}'
                f"<binary>{_b64(spectra.intensity[a:b], np.float32, compress)}</binary></binaryDataArray>"
                f"{mob}</binaryDataArrayList></spectrum>"
            )
        out.write("</spectrumList></run></mzML>")
