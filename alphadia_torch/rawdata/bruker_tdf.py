"""Bruker timsTOF ``.d`` (TDF) input, without a vendor SDK.

The JAX package's ``rawdata/bruker_tdf.py``, with its names and behaviour:
``analysis.tdf`` (SQLite) is read with ``sqlite3`` and ``analysis.tdf_bin``
(a zstd frame a TIMS frame) is memory-mapped. The frames are decoded by the
port's own zstd decoder (``rawdata/zstd.py``, ``csrc/zstd.cpp``) in batch
calls of about 256 MiB of payload, each frame to exactly the size ``Frames``
gives it, ``4 * (NumScans + 2 * NumPeaks)`` bytes (the decoder refuses a
frame whose content differs).

Binary frame layout (TimsCompressionType 2):

- at byte offset ``Frames.TimsId``: ``u32 byte_count`` (including this
  8-byte header), ``u32 scan_count``, then ``byte_count - 8`` bytes of
  zstd frame;
- the decoded payload is a little-endian u32 array stored byte-planar (all
  least significant bytes first, then the second bytes, ...);
- u32 stream: ``blob[0] == scan_count``; ``blob[1:scan_count]`` holds ``2 *
  n_peaks`` of scans 0..scan_count-2 (the last scan's count is implicit);
  then (tof delta, intensity) pairs, the tof indices delta-coded within each
  scan with a +1 offset (true tof = cumsum(deltas) - 1).

Indices become physical units through the acquisition-range model
(sqrt-linear in m/z over the digitizer samples, linear descending in 1/K0
over the scans); the per-run calibration absorbs the residual.
"""

from __future__ import annotations

import logging
import mmap
import sqlite3
from pathlib import Path

import numpy as np

from alphadia_torch.rawdata import zstd
from alphadia_torch.rawdata.source import SpectrumData

logger = logging.getLogger(__name__)

# Frames.MsMsType codes (Bruker TDF schema)
MSMS_TYPE_MS1 = 0
MSMS_TYPE_MSMS = 2
MSMS_TYPE_PASEF = 8
MSMS_TYPE_DIA = 9

# payload bytes decoded by one batch call (a frame larger than this is a
# batch of its own)
DECODE_BATCH_BYTES = 256 * 2**20


class TdfFormatError(ValueError):
    """Raised when a .d directory is malformed or uses an unsupported scheme."""


def _unshuffle_u32(payload) -> np.ndarray:
    """Undo the byte-planar layout: 4 planes of n bytes -> n u32 (LE)."""
    u8 = np.frombuffer(payload, dtype=np.uint8)
    if len(u8) % 4:
        raise TdfFormatError(f"frame payload length {len(u8)} not a multiple of 4")
    n = len(u8) // 4
    planes = u8.reshape(4, n).astype(np.uint32)
    return planes[0] | (planes[1] << 8) | (planes[2] << 16) | (planes[3] << 24)


def _decode_frame_blob(blob: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode one unshuffled u32 frame blob: (scan index, tof index,
    intensity), each u32[n_peaks], scan-major with ascending tof within a
    scan (the on-disk order)."""
    if len(blob) == 0:
        raise TdfFormatError("empty frame blob")
    scan_count = int(blob[0])
    if scan_count < 1 or scan_count > len(blob):
        raise TdfFormatError(f"implausible scan_count {scan_count}")
    n_peaks = (len(blob) - scan_count) // 2
    if scan_count + 2 * n_peaks != len(blob):
        raise TdfFormatError("frame blob length does not match scan_count")
    if n_peaks == 0:
        e = np.empty(0, dtype=np.uint32)
        return e, e.copy(), e.copy()
    counts = np.empty(scan_count, dtype=np.int64)
    counts[:-1] = blob[1:scan_count] // 2
    counts[-1] = n_peaks - counts[:-1].sum()
    if counts[-1] < 0:
        raise TdfFormatError("negative peak count in last scan")
    scan_index = np.repeat(np.arange(scan_count, dtype=np.uint32), counts)
    deltas = blob[scan_count::2].astype(np.int64)
    intensity = blob[scan_count + 1 :: 2]
    # segmented cumsum: the global cumsum less its value before each scan
    cs = np.cumsum(deltas)
    starts = np.zeros(scan_count, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    base = np.where(starts > 0, cs[starts - 1], 0)
    tof = (cs - np.repeat(base, counts) - 1).astype(np.uint32)
    return scan_index, tof, intensity.astype(np.uint32)


def _read_frame(bin_data, offset: int, expected_size: int | None = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read and decode the frame blob at ``offset`` of analysis.tdf_bin."""
    if offset < 0 or offset + 8 > len(bin_data):
        raise TdfFormatError(
            f"frame header at offset {offset} overruns tdf_bin ({len(bin_data)} bytes) — truncated or corrupt file"
        )
    byte_count = int(np.frombuffer(bin_data[offset : offset + 4], dtype="<u4")[0])
    if byte_count < 8 or offset + byte_count > len(bin_data):
        raise TdfFormatError(f"frame at offset {offset} overruns tdf_bin")
    try:
        payload = zstd.decompress(bin_data[offset + 8 : offset + byte_count], expected_size)
    except zstd.ZstdError as e:
        raise TdfFormatError(f"frame at offset {offset}: {e.reason}") from None
    return _decode_frame_blob(_unshuffle_u32(payload))


class TofMzConverter:
    """sqrt-linear index->m/z over the acquisition range (timsrust model)."""

    def __init__(self, mz_min: float, mz_max: float, tof_max_index: int):
        self.intercept = np.sqrt(mz_min)
        self.slope = (np.sqrt(mz_max) - np.sqrt(mz_min)) / tof_max_index

    def __call__(self, tof: np.ndarray) -> np.ndarray:
        s = self.intercept + self.slope * tof.astype(np.float64)
        return (s * s).astype(np.float32)

    def invert(self, mz: np.ndarray) -> np.ndarray:
        return np.round((np.sqrt(np.asarray(mz, dtype=np.float64)) - self.intercept) / self.slope).astype(np.uint32)


class ScanImConverter:
    """linear descending scan->1/K0 (scan 0 = upper mobility bound)."""

    def __init__(self, im_min: float, im_max: float, scan_max_index: int):
        self.intercept = im_max
        self.slope = (im_min - im_max) / scan_max_index

    def __call__(self, scan: np.ndarray) -> np.ndarray:
        return (self.intercept + self.slope * scan.astype(np.float64)).astype(np.float32)

    def invert(self, im: np.ndarray) -> np.ndarray:
        return np.round((np.asarray(im, dtype=np.float64) - self.intercept) / self.slope).astype(np.uint32)


def _metadata(con: sqlite3.Connection) -> dict:
    rows = con.execute("SELECT Key, Value FROM GlobalMetadata").fetchall()
    return {k: v for k, v in rows}


def _tables(tdf: Path) -> tuple[dict, list, dict, dict]:
    """What the reader needs of analysis.tdf: (metadata, the Frames rows
    (Id, Time, MsMsType, TimsId, NumScans, NumPeaks) by Id, frame -> window
    group, window group -> [(ScanNumBegin, ScanNumEnd, IsolationMz,
    IsolationWidth)] by ScanNumBegin)."""
    con = sqlite3.connect(f"file:{tdf}?mode=ro", uri=True)
    try:
        meta = _metadata(con)
        compression = int(float(meta.get("TimsCompressionType", 2)))
        if compression != 2:
            raise TdfFormatError(
                f"TimsCompressionType={compression} not supported (only the modern per-frame zstd scheme, type 2)"
            )
        frames = con.execute("SELECT Id, Time, MsMsType, TimsId, NumScans, NumPeaks FROM Frames ORDER BY Id").fetchall()
        if not frames:
            raise TdfFormatError("Frames table is empty")
        frame_group: dict[int, int] = {}
        group_windows: dict[int, list[tuple[int, int, float, float]]] = {}
        tables = {r[0] for r in con.execute("SELECT name FROM sqlite_master WHERE type='table'").fetchall()}
        if "DiaFrameMsMsInfo" in tables and "DiaFrameMsMsWindows" in tables:
            frame_group = dict(con.execute("SELECT Frame, WindowGroup FROM DiaFrameMsMsInfo"))
            for g, b, e, mz, w in con.execute(
                "SELECT WindowGroup, ScanNumBegin, ScanNumEnd, IsolationMz, IsolationWidth FROM DiaFrameMsMsWindows "
                "ORDER BY WindowGroup, ScanNumBegin"
            ):
                group_windows.setdefault(int(g), []).append((int(b), int(e), float(mz), float(w)))
    finally:
        con.close()
    return meta, frames, frame_group, group_windows


def read_bruker_d(path: str | Path, thread_count: int = 4) -> SpectrumData:
    """Read a Bruker ``.d`` directory into ``SpectrumData``.

    MS1 frames become one spectrum each; diaPASEF frames become one
    pseudo-spectrum per isolation window of their window group (the scan
    slice [ScanNumBegin, ScanNumEnd)), each sorted stably by m/z. Other
    frames (ddaPASEF, bbCID, DIA frames without a window group) are skipped
    with a warning. Per-peak ion mobility is carried. The frames are decoded
    on ``thread_count`` threads.
    """
    path = Path(path)
    tdf, tdf_bin = path / "analysis.tdf", path / "analysis.tdf_bin"
    if not tdf.exists() or not tdf_bin.exists():
        raise TdfFormatError(f"{path} is not a TDF .d directory (need analysis.tdf + analysis.tdf_bin)")
    meta, frames, frame_group, group_windows = _tables(tdf)
    mz_min = float(meta["MzAcqRangeLower"])
    mz_max = float(meta["MzAcqRangeUpper"])
    tof_max = int(float(meta["DigitizerNumSamples"]))
    im_min = float(meta.get("OneOverK0AcqRangeLower", 0.5))
    im_max = float(meta.get("OneOverK0AcqRangeUpper", 1.6))
    scan_max = max(int(f[4]) for f in frames)

    kept, n_skipped = [], {}
    for row in frames:
        msms_type = int(row[2])
        if msms_type == MSMS_TYPE_MS1 or (msms_type == MSMS_TYPE_DIA and int(row[0]) in frame_group):
            kept.append(row)
        else:
            # ddaPASEF (8), bbCID/MRM (2), or DIA frames missing from
            # DiaFrameMsMsInfo: without an isolation annotation they would
            # corrupt the cycle detection
            key = f"MsMsType={msms_type}"
            n_skipped[key] = n_skipped.get(key, 0) + 1
    for key, n in n_skipped.items():
        logger.warning("skipped %d %s frames — only MS1 and annotated diaPASEF frames are searched", n, key)
    if not kept:
        raise TdfFormatError("no usable MS1/DIA frames found")

    # real runs have multi-GB tdf_bin files: mmap pages frames on demand
    with open(tdf_bin, "rb") as f:
        if f.seek(0, 2) == 0:
            raise TdfFormatError(f"{tdf_bin} is empty — truncated or corrupt file")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    try:
        parts = _decode_frames(np.frombuffer(mm, dtype=np.uint8), kept, thread_count)
    finally:
        try:
            mm.close()
        except BufferError:  # a traceback still holds a view: the map goes with it
            pass

    tof2mz = TofMzConverter(mz_min, mz_max, tof_max)
    scan2im = ScanImConverter(im_min, im_max, scan_max)
    return _spectra(kept, parts, frame_group, group_windows, tof2mz, scan2im)


def _decode_frames(buf: np.ndarray, kept: list, thread_count: int) -> list:
    """(scan, tof, intensity) of every kept frame. The frames are decoded in
    batches of about ``DECODE_BATCH_BYTES`` of payload, each split into its
    frames' peaks before the next is decoded, so one batch's payload is held
    at a time."""
    ids = [int(r[0]) for r in kept]
    offsets = np.array([int(r[3]) for r in kept], dtype=np.int64)
    bad = np.nonzero((offsets < 0) | (offsets + 8 > len(buf)))[0]
    if len(bad):
        raise TdfFormatError(
            f"frame header at offset {offsets[bad[0]]} overruns tdf_bin ({len(buf)} bytes) — truncated or corrupt file"
        )
    byte_count = buf[offsets[:, None] + np.arange(4)].copy().view("<u4").ravel().astype(np.int64)
    bad = np.nonzero((byte_count < 8) | (offsets + byte_count > len(buf)))[0]
    if len(bad):
        raise TdfFormatError(f"frame at offset {offsets[bad[0]]} overruns tdf_bin")
    sized = np.array([r[4] is not None and r[5] is not None for r in kept])
    expected = np.array([4 * (int(r[4]) + 2 * int(r[5])) if s else 0 for r, s in zip(kept, sized)], dtype=np.int64)
    bad = [i for i, r in enumerate(kept) if sized[i] and (int(r[4]) < 1 or int(r[5]) < 0)]
    if bad:
        i = bad[0]
        raise TdfFormatError(f"frame {ids[i]}: implausible NumScans {kept[i][4]} and NumPeaks {kept[i][5]}")
    starts, lengths = offsets + 8, byte_count - 8
    batch = np.cumsum(expected) // DECODE_BATCH_BYTES
    bounds = [0, *(np.flatnonzero(np.diff(batch)) + 1).tolist(), len(kept)]
    parts = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        take = a + np.flatnonzero(sized[a:b])
        try:
            out = zstd.decompress_frames(buf, starts[take], lengths[take], expected[take], thread_count)
        except zstd.ZstdError as e:
            where = f"frame {ids[take[e.index]]} at offset {offsets[take[e.index]]}" if e.index >= 0 else "frames"
            raise TdfFormatError(f"{where}: {e.reason}") from None
        end = 0
        for i in range(a, b):
            if sized[i]:
                blob = _unshuffle_u32(out[end : end + expected[i]])
                end += expected[i]
            else:
                try:
                    blob = _unshuffle_u32(zstd.decompress(buf[starts[i] : starts[i] + lengths[i]]))
                except zstd.ZstdError as e:
                    raise TdfFormatError(f"frame {ids[i]} at offset {offsets[i]}: {e.reason}") from None
            scan, tof, inten = _decode_frame_blob(blob)
            if kept[i][5] is not None and len(tof) != int(kept[i][5]):
                raise TdfFormatError(f"frame {ids[i]}: decoded {len(tof)} peaks, Frames.NumPeaks says {kept[i][5]}")
            parts.append((scan, tof, inten))
        del out
    return parts


def _spectra(kept, parts, frame_group, group_windows, tof2mz, scan2im) -> SpectrumData:
    """The spectra of the decoded frames: an MS1 frame whole, a diaPASEF
    frame one slice [begin, end) of scans per window (a frame's peaks are
    scan-major, so each slice is contiguous), each sorted stably by m/z."""
    n_frame_peaks = np.array([len(p[1]) for p in parts], dtype=np.int64)
    scan = np.concatenate([p[0] for p in parts])
    tof = np.concatenate([p[1] for p in parts])
    inten = np.concatenate([p[2] for p in parts])
    # one row a spectrum: its frame, scan range, RT, level and isolation
    spec_frame, lo_scan, hi_scan, rts, levels, iso_mz, iso_w = [], [], [], [], [], [], []
    for f, r in enumerate(kept):
        frame_id, time_s, msms_type = int(r[0]), float(r[1]), int(r[2])
        if msms_type == MSMS_TYPE_DIA:
            for begin, end, mz, w in group_windows.get(frame_group[frame_id], []):
                spec_frame.append(f)
                lo_scan.append(begin)
                hi_scan.append(end)
                rts.append(time_s)
                levels.append(2)
                iso_mz.append(mz)
                iso_w.append(w)
        else:
            spec_frame.append(f)
            lo_scan.append(0)
            hi_scan.append(2**32)
            rts.append(time_s)
            levels.append(1)
            iso_mz.append(np.nan)
            iso_w.append(np.nan)
    if not spec_frame:
        raise TdfFormatError("no usable MS1/DIA frames found")
    spec_frame = np.asarray(spec_frame, dtype=np.int64)
    # a frame's peaks in scan order: key = frame * 2**33 + scan is sorted
    key = np.repeat(np.arange(len(parts), dtype=np.int64), n_frame_peaks) * 2**33 + scan.astype(np.int64)
    base = spec_frame * 2**33
    lo = np.searchsorted(key, base + np.clip(lo_scan, 0, 2**32), side="left")
    hi = np.searchsorted(key, base + np.clip(hi_scan, 0, 2**32), side="left")
    counts = np.maximum(hi - lo, 0)
    starts = np.zeros(len(counts), dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    src = np.repeat(lo - starts, counts) + np.arange(int(counts.sum()), dtype=np.int64)
    mz = tof2mz(tof[src])
    spec = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    # by (spectrum, m/z), stable so that ties keep the scan-major order; the
    # bits of a positive float32 sort as its value
    order = np.argsort((spec << 32) | mz.view(np.int32).astype(np.int64), kind="stable")
    src = src[order]
    iso_mz = np.asarray(iso_mz, dtype=np.float64)
    iso_w = np.asarray(iso_w, dtype=np.float64)
    ms1 = np.asarray(levels) == 1
    return SpectrumData(
        rt=np.asarray(rts, dtype=np.float32),
        ms_level=np.asarray(levels, dtype=np.uint8),
        isolation_lower_mz=np.where(ms1, -1.0, iso_mz - iso_w / 2).astype(np.float32),
        isolation_upper_mz=np.where(ms1, -1.0, iso_mz + iso_w / 2).astype(np.float32),
        peak_start_idx=starts,
        peak_stop_idx=starts + counts,
        mz=mz[order],
        intensity=inten[src].astype(np.float32),
        mobility=scan2im(scan[src]),
    )
