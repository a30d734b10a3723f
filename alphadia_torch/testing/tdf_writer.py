"""Bruker TDF ``.d`` writer for round-trip tests, written from the format
description and sharing no code with ``rawdata/bruker_tdf.py``: a bug in
either side fails the round trip instead of cancelling out.

- ``analysis.tdf_bin``: per frame, ``u32 byte_count`` (the 8-byte header
  included), ``u32 scan_count``, then a zstd frame whose content is a u32
  stream stored byte-planar (all least significant bytes, then the second
  bytes, ...). The stream: ``scan_count``; ``2 * peaks`` of every scan but
  the last; then (tof delta, intensity) pairs, the tof indices of a scan
  delta-coded from -1.
- ``analysis.tdf``: SQLite with ``GlobalMetadata``, ``Frames`` and, for
  diaPASEF frames, ``DiaFrameMsMsInfo`` / ``DiaFrameMsMsWindows``.

No compressor is needed: each zstd frame (RFC 8878) is written of raw
blocks, and of RLE blocks where a block is one byte repeated, always with
``Frame_Content_Size`` and, on request, the xxh64 content checksum. The
encoding is vectorised over every peak of the run; a Python loop runs
once a frame.
"""

from __future__ import annotations

import sqlite3
import struct
from pathlib import Path

import numpy as np

ZSTD_MAGIC = 0xFD2FB528
MAX_BLOCK = 128 * 1024

_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the zstd content checksum keeps its low 32 bits);
    plain Python, for test-sized frames."""
    n = len(data)
    i = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed & _M64, (seed - _P1) & _M64]
        while i + 32 <= n:
            lanes = struct.unpack_from("<4Q", data, i)
            v = [_round(a, b) for a, b in zip(v, lanes)]
            i += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for a in v:
            h = ((h ^ _round(0, a)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, struct.unpack_from("<Q", data, i)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (struct.unpack_from("<I", data, i)[0] * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


def zstd_frame(content: bytes, checksum: bool = False) -> bytes:
    """One zstd frame holding ``content`` uncompressed: single segment,
    ``Frame_Content_Size`` in the smallest field that holds it, raw blocks
    of up to 128 KiB (RLE where a block is one byte repeated)."""
    n = len(content)
    if n < 256:
        fcs_flag, fcs = 0, struct.pack("<B", n)
    elif n < 65536 + 256:
        fcs_flag, fcs = 1, struct.pack("<H", n - 256)
    elif n < 2**32:
        fcs_flag, fcs = 2, struct.pack("<I", n)
    else:
        fcs_flag, fcs = 3, struct.pack("<Q", n)
    descriptor = (fcs_flag << 6) | (1 << 5) | (int(checksum) << 2)
    out = [struct.pack("<IB", ZSTD_MAGIC, descriptor), fcs]
    u8 = np.frombuffer(content, dtype=np.uint8)
    starts = range(0, max(n, 1), MAX_BLOCK)
    for k, a in enumerate(starts):
        block = u8[a : a + MAX_BLOCK]
        last = int(k == len(starts) - 1)
        if len(block) > 1 and not np.any(block != block[0]):
            out.append((last | (1 << 1) | (len(block) << 3)).to_bytes(3, "little"))
            out.append(block[:1].tobytes())
        else:
            out.append((last | (len(block) << 3)).to_bytes(3, "little"))
            out.append(block.tobytes())
    if checksum:
        out.append(struct.pack("<I", xxh64(content) & 0xFFFFFFFF))
    return b"".join(out)


def _frame_stream(n_scans: int, scan: np.ndarray, tof: np.ndarray, inten: np.ndarray) -> np.ndarray:
    """The u32 stream of one frame from its peaks, sorted by (scan, tof)."""
    n = len(tof)
    counts = np.bincount(scan, minlength=n_scans) if n else np.zeros(n_scans, np.int64)
    if len(counts) > n_scans:
        raise ValueError(f"scan index {int(scan.max())} outside the frame's {n_scans} scans")
    prev = np.empty(n, dtype=np.int64)
    if n:
        prev[0] = -1
        prev[1:] = tof[:-1]
        prev[np.r_[True, scan[1:] != scan[:-1]]] = -1
    delta = tof - prev
    if n and delta.min() <= 0:
        raise ValueError("tof indices must be strictly ascending per scan")
    if n and (tof.max() >= 2**32 - 1 or inten.max() >= 2**32 or inten.min() < 0):
        raise ValueError("tof index or intensity does not fit a u32")
    words = np.empty(n_scans + 2 * n, dtype="<u4")
    words[0] = n_scans
    words[1:n_scans] = 2 * counts[:-1]
    words[n_scans::2] = delta
    words[n_scans + 1 :: 2] = inten
    return words


def _frame_blob(words: np.ndarray, n_scans: int, checksum: bool) -> bytes:
    planar = np.ascontiguousarray(words.view(np.uint8).reshape(-1, 4).T).tobytes()
    comp = zstd_frame(planar, checksum)
    return struct.pack("<II", len(comp) + 8, n_scans) + comp


def encode_frame(scan_peaks: list[tuple[np.ndarray, np.ndarray]], checksum: bool = False) -> bytes:
    """Encode one frame: (tof indices ascending, intensities) per scan.

    Returns the complete on-disk blob (8-byte header + zstd frame)."""
    n_scans = len(scan_peaks)
    lens = [len(t) for t, _ in scan_peaks]
    scan = np.repeat(np.arange(n_scans, dtype=np.int64), lens)
    tof = np.concatenate([np.asarray(t, np.int64) for t, _ in scan_peaks]) if n_scans else np.empty(0, np.int64)
    inten = np.concatenate([np.asarray(v, np.int64) for _, v in scan_peaks]) if n_scans else np.empty(0, np.int64)
    return _frame_blob(_frame_stream(n_scans, scan, tof, inten), n_scans, checksum)


def spectrum_data_to_tdf(
    spectra,
    out_dir: str | Path,
    mz_range: tuple[float, float] = (100.0, 1700.0),
    tof_max_index: int = 1_600_000,
    im_range: tuple[float, float] = (0.5, 1.6),
    n_scans: int = 927,
    windows_per_frame: int = 1,
    checksum: bool = False,
) -> Path:
    """Re-encode a ``SpectrumData`` as a Bruker ``.d`` directory.

    m/z -> tof index (sqrt-linear over the acquisition range) and 1/K0 ->
    scan (linear, scan 0 the upper bound), both rounded to the nearest
    index, computed in float64; peaks that meet in one (scan, tof) cell of
    a spectrum are summed; intensities are rounded, at least 1. Each MS1
    spectrum becomes an MS1 frame. With ``windows_per_frame`` 1 each MS2
    spectrum becomes one diaPASEF frame whose window group holds one
    isolation window over every scan. With ``k`` > 1 the MS2 spectra
    between two MS1 spectra go ``k`` at a time into one frame, as
    diaPASEF does: the scans are cut into ``k`` equal ranges and the
    ``j``-th spectrum's scans are squeezed into the ``j``-th
    (``begin + scan * (end - begin) // n_scans``), so each window of the
    group holds one spectrum; the frame takes the first spectrum's RT.
    """
    n_spec = spectra.n_spectra
    counts = (spectra.peak_stop_idx - spectra.peak_start_idx).astype(np.int64)
    spec = np.repeat(np.arange(n_spec, dtype=np.int64), counts)
    first_peak = np.cumsum(counts) - counts
    src = np.repeat(spectra.peak_start_idx.astype(np.int64) - first_peak, counts) + np.arange(int(counts.sum()))
    mz = spectra.mz[src].astype(np.float64)
    sqrt_lo, sqrt_hi = np.sqrt(mz_range[0]), np.sqrt(mz_range[1])
    tof = np.round((np.sqrt(mz) - sqrt_lo) / ((sqrt_hi - sqrt_lo) / tof_max_index)).astype(np.int64)
    if spectra.mobility is not None:
        im = spectra.mobility[src].astype(np.float64)
    else:
        im = np.full(len(src), (im_range[0] + im_range[1]) / 2, np.float32).astype(np.float64)
    scan = np.clip(np.round((im - im_range[1]) / ((im_range[0] - im_range[1]) / n_scans)), 0, n_scans - 1).astype(np.int64)
    inten = np.maximum(np.round(spectra.intensity[src]), 1).astype(np.int64)

    # frames: which spectra, and each spectrum's window within its frame
    ms2 = spectra.ms_level != 1
    frame_of = np.empty(n_spec, np.int64)
    slot = np.zeros(n_spec, np.int64)
    frames: list[dict] = []
    group_of: dict[tuple, int] = {}
    dia_windows: dict[int, list] = {}
    i = 0
    while i < n_spec:
        if not ms2[i]:
            frame_of[i] = len(frames)
            frames.append({"time": float(spectra.rt[i]), "msms_type": 0})
            i += 1
            continue
        j = i
        while j < n_spec and ms2[j] and j - i < windows_per_frame:
            j += 1
        members = range(i, j)
        k = len(members)
        edges = [n_scans * w // k for w in range(k + 1)] if windows_per_frame > 1 else [0, n_scans]
        windows = []
        for w, s in enumerate(members):
            lo, hi = float(spectra.isolation_lower_mz[s]), float(spectra.isolation_upper_mz[s])
            windows.append((edges[w], edges[w + 1], (lo + hi) / 2, hi - lo))
            frame_of[s] = len(frames)
            slot[s] = w
        key = tuple((b, e, round(c, 4), round(wd, 4)) for b, e, c, wd in windows)
        if key not in group_of:
            group_of[key] = len(group_of) + 1
            dia_windows[group_of[key]] = windows
        frames.append({"time": float(spectra.rt[i]), "msms_type": 9, "window_group": group_of[key]})
        i = j
    if windows_per_frame > 1:
        # squeeze each spectrum's scans into its window's range
        win = slot[spec]
        k_of = np.array([len(dia_windows[f["window_group"]]) if f["msms_type"] == 9 else 1 for f in frames], np.int64)
        k = k_of[frame_of[spec]]
        begin, end = n_scans * win // k, n_scans * (win + 1) // k
        scan = np.where(ms2[spec], begin + scan * (end - begin) // n_scans, scan)

    # one (frame, scan, tof) cell a peak: sort, then sum the repeats
    frame = frame_of[spec]
    order = np.lexsort((tof, scan, frame))
    frame, scan, tof, inten = frame[order], scan[order], tof[order], inten[order]
    first = np.r_[True, (frame[1:] != frame[:-1]) | (scan[1:] != scan[:-1]) | (tof[1:] != tof[:-1])] if len(tof) else \
        np.zeros(0, bool)
    starts = np.nonzero(first)[0]
    inten = np.add.reduceat(inten, starts) if len(starts) else inten
    frame, scan, tof = frame[starts], scan[starts], tof[starts]
    bounds = np.searchsorted(frame, np.arange(len(frames) + 1))
    for f, fr in enumerate(frames):
        a, b = bounds[f], bounds[f + 1]
        fr["peaks"] = (scan[a:b], tof[a:b], inten[a:b])
    return write_tdf(
        out_dir, frames, dia_windows=dia_windows, mz_range=mz_range, tof_max_index=tof_max_index,
        im_range=im_range, n_scans=n_scans, checksum=checksum,
    )


def write_tdf(
    out_dir: str | Path,
    frames: list[dict],
    dia_windows: dict[int, list[tuple[int, int, float, float]]] | None = None,
    mz_range: tuple[float, float] = (100.0, 1700.0),
    tof_max_index: int = 400_000,
    im_range: tuple[float, float] = (0.6, 1.5),
    n_scans: int | None = None,
    checksum: bool = False,
) -> Path:
    """Write a ``.d`` directory.

    ``frames``: dicts with ``time`` (s), ``msms_type`` (0 MS1 / 9 DIA),
    ``window_group`` (DIA) and either ``scans``, a list of (tof indices,
    intensities) per scan from scan 0, or ``peaks``, flat (scan, tof,
    intensity) arrays sorted by (scan, tof) over ``n_scans`` scans.
    ``dia_windows``: window group -> [(scan begin, scan end, isolation m/z,
    isolation width)].
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    pos = 0
    with open(out_dir / "analysis.tdf_bin", "wb") as f:
        for i, fr in enumerate(frames):
            if "scans" in fr:
                blob = encode_frame(fr["scans"], checksum)
                n_sc = len(fr["scans"])
                inten = np.concatenate([np.asarray(v, np.int64) for _, v in fr["scans"]]) if n_sc else np.empty(0, np.int64)
            else:
                scan, tof, inten = (np.asarray(x, np.int64) for x in fr["peaks"])
                n_sc = n_scans
                blob = _frame_blob(_frame_stream(n_sc, scan, tof, inten), n_sc, checksum)
            f.write(blob)
            rows.append((
                i + 1, fr["time"], 9, fr["msms_type"], pos, n_sc, len(inten),
                int(inten.max()) if len(inten) else 0, int(inten.sum()),
            ))
            pos += len(blob)

    db = out_dir / "analysis.tdf"
    if db.exists():
        db.unlink()
    con = sqlite3.connect(db)
    try:
        con.execute("CREATE TABLE GlobalMetadata (Key TEXT, Value TEXT)")
        meta = {
            "TimsCompressionType": "2",
            "MzAcqRangeLower": repr(float(mz_range[0])),
            "MzAcqRangeUpper": repr(float(mz_range[1])),
            "DigitizerNumSamples": str(tof_max_index),
            "OneOverK0AcqRangeLower": repr(float(im_range[0])),
            "OneOverK0AcqRangeUpper": repr(float(im_range[1])),
            "SchemaType": "TDF",
        }
        con.executemany("INSERT INTO GlobalMetadata VALUES (?, ?)", meta.items())
        con.execute(
            "CREATE TABLE Frames (Id INTEGER PRIMARY KEY, Time REAL, ScanMode INTEGER, MsMsType INTEGER, "
            "TimsId INTEGER, NumScans INTEGER, NumPeaks INTEGER, MaxIntensity INTEGER, SummedIntensities INTEGER)"
        )
        con.executemany("INSERT INTO Frames VALUES (?,?,?,?,?,?,?,?,?)", rows)
        if dia_windows:
            con.execute("CREATE TABLE DiaFrameMsMsInfo (Frame INTEGER, WindowGroup INTEGER)")
            con.executemany(
                "INSERT INTO DiaFrameMsMsInfo VALUES (?, ?)",
                [(i + 1, fr["window_group"]) for i, fr in enumerate(frames) if fr["msms_type"] == 9],
            )
            con.execute(
                "CREATE TABLE DiaFrameMsMsWindows (WindowGroup INTEGER, ScanNumBegin INTEGER, ScanNumEnd INTEGER, "
                "IsolationMz REAL, IsolationWidth REAL, CollisionEnergy REAL)"
            )
            con.executemany(
                "INSERT INTO DiaFrameMsMsWindows VALUES (?,?,?,?,?,?)",
                [(g, b, e, mz, w, 30.0) for g, ws in dia_windows.items() for b, e, mz, w in ws],
            )
        con.commit()
    finally:
        con.close()
    return out_dir
