"""MS-Numpress codecs (linear / slof / positive-integer), vectorized numpy
(decode does one cheap O(n_values) Python walk to locate the
variable-length heads; everything else is array ops).

Implements the public MS-Numpress specification (Teleman et al., MCP 2014,
"Numerical compression schemes for proteomics mass spectrometry data";
reference C++: ms-numpress/MSNumpress.cpp), so that mzML files written with
numpress encoding are read directly. numpy and ``struct`` only: the same
codec as the JAX package's ``rawdata/numpress.py``.

Wire formats (all little-endian except the fixed point):

- **linear** (``MS:1002312``): 8-byte big-endian double fixed point F;
  two 4-byte unsigned ints = round(v*F) of the first two values; then for
  each value the signed difference from the linear extrapolation
  ``2*prev - prevprev`` in the variable-length nibble code below.
- **slof** (``MS:1002314``): 8-byte big-endian double fixed point F; each
  value a 2-byte unsigned short ``round(log(1+v)*F)``; decode
  ``exp(x/F)-1``.
- **pic** (``MS:1002313``): each value ``round(v)`` in the nibble code,
  no header.

Nibble code for one 32-bit two's-complement int: a head nibble ``h``;
``h<=8`` means ``h`` leading 0x0 nibbles, ``h>8`` means ``h-8`` leading
0xf nibbles; the remaining ``8-n`` nibbles follow least-significant
first. An odd total nibble count is padded with a trailing 0x0 nibble.

Encoders are provided for fixture generation and round-trip tests.
"""

from __future__ import annotations

import struct

import numpy as np


def _to_nibbles(data: bytes | np.ndarray) -> np.ndarray:
    """Byte stream -> uint8 nibble stream (high nibble first per byte)."""
    b = np.frombuffer(bytes(data), dtype=np.uint8)
    out = np.empty(2 * len(b), np.uint8)
    out[0::2] = b >> 4
    out[1::2] = b & 0xF
    return out


def _from_nibbles(nibbles: list[int]) -> bytes:
    if len(nibbles) % 2:
        nibbles = nibbles + [0]
    arr = np.asarray(nibbles, np.uint8)
    return ((arr[0::2] << 4) | arr[1::2]).tobytes()


def _decode_ints(nibbles: np.ndarray) -> np.ndarray:
    """Decode the variable-length nibble stream into signed 32-bit ints.

    One cheap O(n_values) Python walk finds the head-nibble positions
    (the chain is data-dependent); the value assembly itself is
    vectorized numpy, so cost per peak is ~a dozen ns-scale ops instead
    of a Python loop per nibble."""
    nib = np.asarray(nibbles, np.uint8)
    n_nib = len(nib)
    # head h encodes n leading nibbles (h or h-8), so 1+k = 9-n to skip
    skip = (
        9 - np.where(nib > 8, nib - 8, nib).astype(np.int64)
    ).tolist()  # plain-int list: fast scalar reads in the walk
    heads: list[int] = []
    append = heads.append
    i = 0
    while i < n_nib:
        append(i)
        i += skip[i]
    if heads and i > n_nib:
        # the final head overran: either a lone trailing 0x0 pad nibble
        # (dropped) or a genuinely truncated stream
        last = heads[-1]
        if nib[last] == 0 and last + 1 >= n_nib:
            heads.pop()
        else:
            raise ValueError("truncated numpress nibble stream")
    if not heads:
        return np.zeros(0, np.int64)
    h = np.asarray(heads, np.int64)
    hvals = nib[h].astype(np.int32)
    counts = np.where(hvals <= 8, 8 - hvals, 16 - hvals)  # following nibbles
    # out-of-count lanes read a zero sentinel appended past the stream —
    # no mask/where on the wide gathered array
    nib_pad = np.concatenate([nib, np.zeros(9, np.uint8)])
    K = np.arange(8, dtype=np.int64)
    idx = h[:, None] + 1 + K[None, :]
    idx[K[None, :] >= counts[:, None]] = n_nib + 8  # sentinel = 0
    vals = nib_pad[idx].astype(np.uint32)
    res = (vals << (4 * K[None, :].astype(np.uint32))).sum(
        axis=1, dtype=np.uint32
    ).astype(np.int64)
    # leading 0xf nibbles at the TOP of the 32-bit word (negative form)
    n_lead = np.where(hvals > 8, hvals - 8, 0).astype(np.int64)
    fmask = np.where(
        hvals > 8, (0xFFFFFFFF << (4 * (8 - n_lead))) & 0xFFFFFFFF, 0
    )
    res = res | fmask
    return np.where(res & 0x80000000, res - (1 << 32), res)


def _encode_int(x: int, out: list[int]) -> None:
    m = x & 0xFFFFFFFF
    if m >> 28 == 0xF:  # leading-ones (negative) form
        n = 0
        while n < 7 and (m >> (4 * (7 - n))) & 0xF == 0xF:
            n += 1
        out.append(8 + n)
    else:
        n = 0
        while n < 8 and (m >> (4 * (7 - n))) & 0xF == 0:
            n += 1
        out.append(n)
    for j in range(8 - n):
        out.append((m >> (4 * j)) & 0xF)


def _read_fixed_point(data: bytes) -> float:
    if len(data) < 8:
        raise ValueError("numpress buffer too short for fixed-point header")
    return struct.unpack(">d", bytes(data[:8]))[0]


# ---------------------------------------------------------------- linear
def decode_linear(data: bytes) -> np.ndarray:
    fixed = _read_fixed_point(data)
    if len(data) == 8:
        return np.zeros(0, np.float64)
    if len(data) < 12:
        raise ValueError("corrupt numpress-linear buffer")
    # seeds are signed 32-bit two's complement in the MS-Numpress spec
    # (the encoder stores value & 0xFFFFFFFF)
    first = struct.unpack("<i", bytes(data[8:12]))[0]
    if len(data) < 16:
        return np.array([first / fixed], np.float64)
    second = struct.unpack("<i", bytes(data[12:16]))[0]
    diffs = _decode_ints(_to_nibbles(data[16:]))
    # ints[k] = 2*ints[k-1] - ints[k-2] + d[k]: the first difference
    # e[k] = ints[k] - ints[k-1] obeys e[k] = e[k-1] + d[k], so the whole
    # chain is two cumulative sums (vectorized, exact in int64)
    e = (second - first) + np.cumsum(diffs)
    ints = np.concatenate(
        [np.array([first, second], np.int64), second + np.cumsum(e)]
    )
    # the reference decoder computes the recurrence in 32-bit ints; mod-2^32
    # arithmetic is a ring homomorphism, so wrapping the exact int64 chain
    # at the end reproduces its per-step wraparound
    ints = ((ints + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return ints / fixed


def optimal_linear_fixed_point(values: np.ndarray) -> float:
    values = np.asarray(values, np.float64)
    if len(values) == 0:
        return 0.0
    vmax = max(float(np.abs(values).max()), 1.0)
    return np.floor(0x7FFFFFFF / vmax)


def encode_linear(values: np.ndarray, fixed_point: float | None = None) -> bytes:
    values = np.asarray(values, np.float64)
    fixed = float(fixed_point or optimal_linear_fixed_point(values))
    head = struct.pack(">d", fixed)
    ints = np.round(values * fixed).astype(np.int64)
    if len(values) == 0:
        return head
    out = head + struct.pack("<I", int(ints[0]) & 0xFFFFFFFF)
    if len(values) == 1:
        return out
    out += struct.pack("<I", int(ints[1]) & 0xFFFFFFFF)
    nibbles: list[int] = []
    for k in range(2, len(ints)):
        extrapol = ints[k - 1] + (ints[k - 1] - ints[k - 2])
        _encode_int(int(ints[k] - extrapol), nibbles)
    return out + _from_nibbles(nibbles)


# ------------------------------------------------------------------ slof
def decode_slof(data: bytes) -> np.ndarray:
    fixed = _read_fixed_point(data)
    body = np.frombuffer(bytes(data[8:]), dtype="<u2").astype(np.float64)
    return np.exp(body / fixed) - 1.0


def optimal_slof_fixed_point(values: np.ndarray) -> float:
    values = np.asarray(values, np.float64)
    if len(values) == 0:
        return 0.0
    lmax = max(float(np.log1p(np.abs(values)).max()), 1.0)
    return np.floor(0xFFFF / lmax)


def encode_slof(values: np.ndarray, fixed_point: float | None = None) -> bytes:
    values = np.asarray(values, np.float64)
    fixed = float(fixed_point or optimal_slof_fixed_point(values))
    shorts = np.round(np.log1p(values) * fixed).astype("<u2")
    return struct.pack(">d", fixed) + shorts.tobytes()


# ------------------------------------------------------------------- pic
def decode_pic(data: bytes) -> np.ndarray:
    return _decode_ints(_to_nibbles(data)).astype(np.float64)


def encode_pic(values: np.ndarray) -> bytes:
    nibbles: list[int] = []
    for v in np.round(np.asarray(values, np.float64)).astype(np.int64):
        if v < 0:
            raise ValueError("numpress-pic encodes non-negative counts only")
        _encode_int(int(v), nibbles)
    return _from_nibbles(nibbles)
