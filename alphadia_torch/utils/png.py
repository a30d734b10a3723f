"""PNG writing and reading in numpy and the standard library (the card
machine has no PIL and no matplotlib).

``write_png`` writes 8-bit RGBA, non-interlaced, as matplotlib's Agg
backend does: IHDR, one IDAT (zlib), IEND, each chunk with its CRC-32. Rows
are stored unfiltered (filter type 0): on a figure's runs of one colour
zlib alone compresses as well as the adaptive filters do, at a tenth of the
time.

``read_png`` reads 8-bit, non-interlaced files of colour types 2 (RGB)
and 6 (RGBA) with any of the five filters, as matplotlib, PIL and
``write_png`` write them, and returns uint8[H, W, C] with the file's
channels. A filtered row depends on the decoded row above
it and on the pixel to its left, so the decoder walks the image's
anti-diagonals: each step decodes every pixel of one diagonal at once.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _paeth(a, b, c):
    """The Paeth predictor of int16 arrays: a left, b above, c above-left."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(rgba: np.ndarray, level: int = 6) -> bytes:
    """The bytes of a PNG of ``rgba`` (uint8[H, W, 4])."""
    rgba = np.ascontiguousarray(rgba)
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"write_png takes uint8[H, W, 4], got {rgba.dtype}{list(rgba.shape)}")
    H, W, _ = rgba.shape
    if H == 0 or W == 0:
        raise ValueError("a PNG has at least one pixel")
    rows = np.empty((H, W * 4 + 1), np.uint8)
    rows[:, 0] = 0  # filter type 0: a plot's runs of one colour compress as well unfiltered
    rows[:, 1:] = rgba.reshape(H, W * 4)
    header = struct.pack(">IIBBBBB", W, H, 8, 6, 0, 0, 0)
    return (
        SIGNATURE + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b"")
    )


def write_png(path, rgba: np.ndarray, level: int = 6) -> Path:
    """Write ``rgba`` (uint8[H, W, 4]) to ``path`` as an 8-bit RGBA PNG."""
    path = Path(path)
    path.write_bytes(encode_png(rgba, level))
    return path


def decode_png(data: bytes) -> np.ndarray:
    """uint8[H, W, C] of a PNG's bytes (see the module note for what it reads)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind == b"PLTE" or not kind[0] & 0x20:
            raise ValueError(f"PNG chunk {kind.decode('latin-1')} is not read here (palette or unknown critical chunk)")
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    W, H, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {color}, interlace {interlace} is not read here")
    C = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (W * C + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {H * (W * C + 1)}")
    raw = raw.reshape(H, W * C + 1)
    kind = raw[:, 0].astype(np.int64)
    if (kind > 4).any():
        raise ValueError(f"PNG filter type {int(kind.max())} is not one of 0-4")
    f = raw[:, 1:].reshape(H, W, C).astype(np.int16)
    # one padding row above and one padding column left hold the zeros that
    # the filters read outside the image
    out = np.zeros((H + 1, W + 1, C), np.int16)
    for d in range(H + W - 1):
        i = np.arange(max(0, d - W + 1), min(H, d + 1))
        j = d - i
        a, b, c = out[i + 1, j], out[i, j + 1], out[i, j]
        k = kind[i][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4], [a, b, (a + b) // 2, _paeth(a, b, c)], 0)
        out[i + 1, j + 1] = (f[i, j] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """uint8[H, W, C] of the PNG at ``path`` (C: 3 or 4, as stored)."""
    return decode_png(Path(path).read_bytes())
