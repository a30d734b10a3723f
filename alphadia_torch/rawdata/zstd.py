"""The zstd frame decoder of ``csrc/zstd.cpp``, built and bound with ctypes.

The card machine has no zstd package, so the port decodes the frames of
Bruker TDF files itself. The library is built at first use with the host's
C++ compiler (``utils/cxx.build_library``: ``build/alphadia_torch/``, named
by a hash of the source and flags). Without a compiler, or when the build
fails, the calls raise: there is no other path.

- ``decompress(data, expected_size=None)``: every frame of ``data``.
- ``decompress_frames(buffer, offsets, lengths, expected_sizes, threads)``:
  N inputs of one buffer, each decoded to exactly its expected size, into
  one output array, on ``threads`` threads (the bytes do not depend on
  their count).

Malformed input raises ``ZstdError`` with the decoder's message.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from alphadia_torch.utils.cxx import build_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "zstd.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_ERR_CAP = 256

_lib = None
_lock = threading.Lock()


class ZstdError(ValueError):
    """Raised for input that is not a valid zstd frame sequence: ``reason``
    is the decoder's message, ``index`` the input it was found in."""

    def __init__(self, reason: str, index: int = 0):
        super().__init__(f"input {index}: {reason}")
        self.reason, self.index = reason, index


def build() -> Path:
    """Compile ``csrc/zstd.cpp`` once per source content and flags; return
    the shared library's path."""
    return build_library(SOURCE, CXX_FLAGS, "libzstd", "the zstd decoder")


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, LL = ctypes.c_void_p, ctypes.c_int64
            lib.zstd_decode_batch.argtypes = [P, LL, P, P, P, LL, P, P, LL, ctypes.c_int, ctypes.c_char_p, LL, P]
            lib.zstd_decode_batch.restype = ctypes.c_int
            lib.zstd_decode_alloc.argtypes = [P, LL, P, ctypes.c_char_p, LL]
            lib.zstd_decode_alloc.restype = ctypes.c_void_p
            lib.zstd_free.argtypes = [P]
            lib.zstd_free.restype = None
            _lib = lib
        return _lib


def _u8(data) -> np.ndarray:
    arr = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    if arr.dtype != np.uint8 or arr.ndim != 1:
        raise TypeError("input must be bytes-like or a 1-D uint8 array")
    return np.ascontiguousarray(arr)


def _ptr(arr: np.ndarray) -> int | None:
    return arr.ctypes.data if arr.size else None


def decompress(data, expected_size: int | None = None) -> bytes:
    """Decode every frame of ``data`` (skippable frames give nothing). With
    ``expected_size`` the content must be exactly that long."""
    arr = _u8(data)
    if expected_size is not None:
        out = decompress_frames(arr, [0], [arr.size], [expected_size], threads=1)
        return out.tobytes()
    lib = _library()
    err = ctypes.create_string_buffer(_ERR_CAP)
    size = ctypes.c_int64(0)
    ptr = lib.zstd_decode_alloc(_ptr(arr), arr.size, ctypes.byref(size), err, _ERR_CAP)
    if not ptr:
        raise ZstdError(err.value.decode(errors="replace"))
    try:
        return ctypes.string_at(ptr, size.value)
    finally:
        lib.zstd_free(ptr)


def decompress_frames(buffer, offsets, lengths, expected_sizes, threads: int = 1) -> np.ndarray:
    """Decode input ``i``, the bytes ``buffer[offsets[i]:offsets[i] +
    lengths[i]]``, to exactly ``expected_sizes[i]`` bytes; return them one
    after another as one uint8 array. Raises ``ZstdError`` naming the first
    input that fails."""
    src = _u8(buffer)
    off = np.ascontiguousarray(offsets, dtype=np.int64)
    length = np.ascontiguousarray(lengths, dtype=np.int64)
    size = np.ascontiguousarray(expected_sizes, dtype=np.int64)
    n = len(off)
    if len(length) != n or len(size) != n:
        raise ValueError("offsets, lengths and expected_sizes must have one entry per input")
    if n and (off.min() < 0 or length.min() < 0 or size.min() < 0 or (off + length).max() > src.size):
        raise ValueError("an input lies outside the buffer or has a negative size")
    dst_off = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(size[:-1], out=dst_off[1:])
    dst = np.empty(int(size.sum()), dtype=np.uint8)
    if n == 0:
        return dst
    err = ctypes.create_string_buffer(_ERR_CAP)
    bad = ctypes.c_int64(-1)
    rc = _library().zstd_decode_batch(
        _ptr(src), src.size, off.ctypes.data, length.ctypes.data, _ptr(dst), dst.size, dst_off.ctypes.data,
        size.ctypes.data, n, max(1, int(threads)), err, _ERR_CAP, ctypes.byref(bad),
    )
    if rc != 0:
        raise ZstdError(err.value.decode(errors="replace"), bad.value)
    return dst
