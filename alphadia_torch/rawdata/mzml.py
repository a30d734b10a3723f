"""Streaming mzML reader on the standard library's ``xml.etree.ElementTree``.

The JAX package's ``rawdata/mzml.py`` reads with lxml, which the card
machine lacks; this reader gives the same ``SpectrumData`` (RT in seconds,
isolation bounds, flat peak arrays sorted by m/z within each spectrum):

- the ``indexedmzML`` wrapper and its trailing byte-offset index; plain or
  gzipped (``.mzML.gz``) files;
- 32/64-bit float arrays, zlib or no compression, MS-Numpress arrays
  (linear / slof / pic, each optionally + zlib; ``rawdata/numpress.py``);
- ms level, scan start time (minutes or seconds, by ``unitAccession`` or
  ``unitName``) and the isolation window;
- ion mobility: per-peak arrays (``MS:1002816`` / ``MS:1003006`` /
  ``MS:1003007``) or one scan mobility (``MS:1002815``) broadcast over the
  spectrum's peaks;
- profile-mode spectra (``MS:1000128``) are centroided on the fly
  (:func:`centroid_profile`).

Each spectrum is dropped from the tree once it is read, so memory stays
that of one spectrum whatever the file's size.
"""

from __future__ import annotations

import base64
import logging
import zlib
from pathlib import Path
from xml.etree import ElementTree

import numpy as np

from alphadia_torch.rawdata import numpress
from alphadia_torch.rawdata.source import SpectrumData

logger = logging.getLogger(__name__)

_NS = "{http://psi.hupo.org/ms/mzml}"
_SPECTRUM = f"{_NS}spectrum"

# PSI-MS accessions
ACC_MS_LEVEL = "MS:1000511"
ACC_SCAN_START = "MS:1000016"
ACC_ISO_TARGET = "MS:1000827"
ACC_ISO_LOWER = "MS:1000828"
ACC_ISO_UPPER = "MS:1000829"
ACC_MZ_ARRAY = "MS:1000514"
ACC_INT_ARRAY = "MS:1000515"
ACC_F64 = "MS:1000523"
ACC_F32 = "MS:1000521"
ACC_ZLIB = "MS:1000574"
ACC_NO_COMP = "MS:1000576"
ACC_PROFILE = "MS:1000128"
# ion mobility
ACC_MOB_ARRAY_MEAN_INV = "MS:1002816"  # mean inverse reduced ion mobility array
ACC_MOB_ARRAY_MEAN = "MS:1003006"  # mean ion mobility array
ACC_MOB_ARRAY_RAW_INV = "MS:1003007"  # raw inverse reduced ion mobility array
ACC_SCAN_INV_MOB = "MS:1002815"  # inverse reduced ion mobility (scan-level)
# MS-Numpress: (codec, zlib after numpress) per accession
ACC_NUMPRESS = {
    "MS:1002312": ("linear", False),
    "MS:1002313": ("pic", False),
    "MS:1002314": ("slof", False),
    "MS:1002746": ("linear", True),
    "MS:1002747": ("pic", True),
    "MS:1002748": ("slof", True),
}
# time units
UNIT_MINUTE = "UO:0000031"
UNIT_SECOND = "UO:0000010"

_MOB_ARRAY_ACCS = {ACC_MOB_ARRAY_MEAN_INV, ACC_MOB_ARRAY_MEAN, ACC_MOB_ARRAY_RAW_INV}
_NUMPRESS_DECODE = {"linear": numpress.decode_linear, "slof": numpress.decode_slof, "pic": numpress.decode_pic}


def _decode_binary(data_elem) -> tuple[str | None, np.ndarray]:
    """One ``<binaryDataArray>`` -> (kind, values)."""
    dtype = np.float64
    compressed = False
    kind = None
    codec = None
    for cv in data_elem.iter(f"{_NS}cvParam"):
        acc = cv.get("accession")
        if acc == ACC_F64:
            dtype = np.float64
        elif acc == ACC_F32:
            dtype = np.float32
        elif acc == ACC_ZLIB:
            compressed = True
        elif acc == ACC_MZ_ARRAY:
            kind = "mz"
        elif acc == ACC_INT_ARRAY:
            kind = "intensity"
        elif acc in _MOB_ARRAY_ACCS:
            kind = "mobility"
        elif acc in ACC_NUMPRESS:
            # a plain numpress accession may come with a separate zlib
            # cvParam, in either order: never clear a zlib flag seen already
            codec, np_zlib = ACC_NUMPRESS[acc]
            compressed = compressed or np_zlib
    b = data_elem.find(f"{_NS}binary")
    if b is None or not b.text:
        return kind, np.zeros(0, dtype)
    raw = base64.b64decode(b.text)
    if compressed:
        raw = zlib.decompress(raw)
    if codec is not None:
        return kind, _NUMPRESS_DECODE[codec](raw)
    return kind, np.frombuffer(raw, dtype=dtype)


def _rt_seconds(cv) -> float:
    """Scan start time -> seconds, ``unitAccession`` before ``unitName``."""
    rt = float(cv.get("value"))
    unit_acc = cv.get("unitAccession")
    if unit_acc == UNIT_SECOND:
        return rt
    if unit_acc == UNIT_MINUTE:
        return rt * 60.0
    unit = cv.get("unitName", "minute")
    return rt * 60.0 if unit.startswith("minute") else rt


def centroid_profile(mz: np.ndarray, intensity: np.ndarray, mobility: np.ndarray | None = None):
    """Centroid one profile-mode spectrum.

    The trace splits into segments at zero-intensity gaps and at local
    minima; each segment gives one centroid, the intensity-weighted mean m/z
    (and mobility, if given) with the summed intensity. Returns (mz,
    intensity, mobility or None), m/z ascending.
    """
    n = len(mz)
    pos = intensity > 0
    if n < 3 or not pos.any():
        keep = pos
        return mz[keep], intensity[keep], mobility[keep] if mobility is not None else None
    d = np.diff(intensity)
    valley = np.zeros(n, bool)
    valley[1:-1] = (d[:-1] < 0) & (d[1:] > 0)
    # a segment starts at the first positive point after a gap or at a valley
    start = pos & (~np.concatenate(([False], pos[:-1])) | valley)
    seg_id = np.cumsum(start) - 1
    ids = seg_id[pos]
    w = intensity[pos].astype(np.float64)
    n_seg = int(ids[-1]) + 1
    tot = np.bincount(ids, weights=w, minlength=n_seg)
    cmz = np.bincount(ids, weights=w * mz[pos], minlength=n_seg) / tot
    cmob = None
    if mobility is not None:
        cmob = (np.bincount(ids, weights=w * mobility[pos], minlength=n_seg) / tot).astype(np.float32)
    return cmz.astype(np.float32), tot.astype(np.float32), cmob


def _spectra(source):
    """The ``<spectrum>`` elements of a document, each complete, in order;
    each is removed from its parent once the caller has read it."""
    open_elems = []
    for event, elem in ElementTree.iterparse(source, events=("start", "end")):
        if event == "start":
            open_elems.append(elem)
            continue
        open_elems.pop()
        if elem.tag == _SPECTRUM:
            yield elem
            elem.clear()
            if open_elems:
                open_elems[-1].remove(elem)


def read_mzml(path: str | Path, thread_count: int = 4) -> SpectrumData:
    rts, levels, iso_lo, iso_hi = [], [], [], []
    mz_chunks, int_chunks, mob_chunks = [], [], []
    any_mobility = False
    n_profile = 0

    # converters often gzip whole files (.mzML.gz): decompress on the fly
    if str(path).lower().endswith(".gz"):
        import gzip

        source = gzip.open(str(path), "rb")
    else:
        source = open(path, "rb")
    try:
        for spec in _spectra(source):
            ms_level = 1
            rt = 0.0
            target = lower_off = upper_off = None
            scan_mobility = None
            is_profile = False

            for cv in spec.iter(f"{_NS}cvParam"):
                acc = cv.get("accession")
                if acc == ACC_MS_LEVEL:
                    ms_level = int(cv.get("value"))
                elif acc == ACC_SCAN_START:
                    rt = _rt_seconds(cv)
                elif acc == ACC_ISO_TARGET:
                    target = float(cv.get("value"))
                elif acc == ACC_ISO_LOWER:
                    lower_off = float(cv.get("value"))
                elif acc == ACC_ISO_UPPER:
                    upper_off = float(cv.get("value"))
                elif acc == ACC_SCAN_INV_MOB:
                    scan_mobility = float(cv.get("value"))
                elif acc == ACC_PROFILE:
                    is_profile = True
                    n_profile += 1

            if target is not None:
                lo = target - (lower_off if lower_off is not None else 0.0)
                hi = target + (upper_off if upper_off is not None else 0.0)
            else:
                lo = hi = -1.0

            mz = inten = np.zeros(0, np.float32)
            mob = None
            for arr_elem in spec.iter(f"{_NS}binaryDataArray"):
                kind, vals = _decode_binary(arr_elem)
                if kind == "mz":
                    mz = vals.astype(np.float32)
                elif kind == "intensity":
                    inten = vals.astype(np.float32)
                elif kind == "mobility":
                    mob = vals.astype(np.float32)

            if mob is None and scan_mobility is not None:
                mob = np.full(len(mz), scan_mobility, np.float32)
            if mob is not None and len(mob) != len(mz):
                mob = None  # malformed array: drop rather than misalign

            if is_profile and len(mz):
                mz, inten, mob = centroid_profile(mz, inten, mob)

            if ms_level == 1:
                lo = hi = -1.0
            order = np.argsort(mz, kind="stable")
            rts.append(rt)
            levels.append(ms_level)
            iso_lo.append(lo)
            iso_hi.append(hi)
            mz_chunks.append(mz[order])
            int_chunks.append(inten[order])
            if mob is not None:
                any_mobility = True
                mob_chunks.append(mob[order])
            else:
                mob_chunks.append(np.zeros(len(mz), np.float32))
    finally:
        source.close()

    if n_profile:
        logger.info("mzML: centroided %d profile-mode spectra (weighted-centroid peak picking)", n_profile)

    n = len(rts)
    start = np.zeros(n, dtype=np.int64)
    counts = np.array([len(c) for c in mz_chunks], dtype=np.int64)
    if n > 1:
        np.cumsum(counts[:-1], out=start[1:])
    logger.info("mzML: %d spectra, %s peaks from %s", n, f"{int(counts.sum()):,}", path)
    return SpectrumData(
        rt=np.array(rts, np.float32),
        ms_level=np.array(levels, np.uint8),
        isolation_lower_mz=np.array(iso_lo, np.float32),
        isolation_upper_mz=np.array(iso_hi, np.float32),
        peak_start_idx=start,
        peak_stop_idx=start + counts,
        mz=np.concatenate(mz_chunks) if mz_chunks else np.zeros(0, np.float32),
        intensity=np.concatenate(int_chunks) if int_chunks else np.zeros(0, np.float32),
        mobility=np.concatenate(mob_chunks) if (any_mobility and mob_chunks) else None,
    )
