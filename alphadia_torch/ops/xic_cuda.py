"""Wrapper of the CUDA XIC kernel (``csrc/xic.cu``).

``extract_xic_cuda`` computes what ``ops/xic.extract_xic`` computes, from
the ``PeakStore`` of ``DiaData.device_arrays``: m/z and intensity, and the
cycle plane (u16, cycle mod 2**16) that the kernel reads for each peak's
cell. Two additions: ``cycle_stride`` (a power of two) for the coarse cell
view of a strided ``cell_start``, and the per-candidate scan window
``scan_lo``/``scan_hi`` over the store's scan-bin plane. On CPU tensors it
runs the plain version, which takes each cell's peaks from ``cell_start``
and does not read the cycle plane; on CUDA tensors it launches the kernel
or raises.

The kernel is built with nvcc at first use into ``build/alphadia_torch/``
(route: a shared library with a plain C interface, loaded with ctypes).
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from alphadia_torch.ops.xic import extract_xic_packed

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "xic.cu"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

launches = 0  # kernel launches since import (or since a caller reset it)

_lib = None
_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("ALPHADIA_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "alphadia_torch"


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the XIC kernel is built from csrc/xic.cu")


def build(verbose: bool = False, defines: dict | None = None) -> Path:
    """Compile ``csrc/xic.cu`` (once per source content and ``defines``, the
    kernel's tuned constants overridden by a sweep); return the .so path."""
    flags = NVCC_FLAGS + [f"-D{k}={v}" for k, v in sorted((defines or {}).items())]
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    out = build_dir() / f"libxic_{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, out)
    return out


def load(defines: dict | None = None):
    """Build (if needed) and load the kernel's library, which launches from
    now on; ``defines`` as for :func:`build`."""
    global _lib
    lib = ctypes.CDLL(str(build(defines=defines)))
    fn = lib.xic_launch
    P, LL, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    fn.argtypes = [
        P, P, P, LL,  # peaks, cycle, scanbin, n_peaks
        P, LL, I, I, I,  # cell_start, row_len, n_slots, n_bins, n_cycles
        P, P, P, P, P,  # slot_idx, query_mz, cycle_start, scan_lo, scan_hi
        I, I, I, I, I,  # B, Q, W, slab, stride_shift
        F, F, F, F,  # lo_factor, hi_factor, bin_mz_min, bin_width
        I, I,  # with_mz, mz_as_delta
        P, P, P,  # out_int, out_mz, stream
    ]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _library():
    with _lock:
        return _lib if _lib is not None else load()


def _check(t, name, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def extract_xic_cuda(
    store,  # PeakStore (DiaData.device_arrays)
    cell_start: torch.Tensor,  # i32[n_slots, n_bins, n_cycles+1]
    slot_idx: torch.Tensor,  # i32[B, Q]
    query_mz: torch.Tensor,  # f32[B, Q]
    tol_ppm: float,
    cycle_start: torch.Tensor,  # i32[B]
    *,
    n_cycles: int,
    n_bins: int,
    bin_mz_min: float,
    bin_width: float,
    slab: int = 256,
    window_len: int = 64,
    with_mz: bool = False,
    mz_as_delta: bool = False,
    cycle_stride: int = 1,
    scan_lo: torch.Tensor | None = None,  # i32[B]
    scan_hi: torch.Tensor | None = None,  # i32[B], exclusive
):
    """Dense XICs f32[B, Q, W] (and the m/z plane with ``with_mz``)."""
    global launches
    if cycle_stride < 1 or cycle_stride & (cycle_stride - 1):
        raise ValueError(f"cycle_stride must be a power of two, got {cycle_stride}")
    if (scan_lo is None) != (scan_hi is None):
        raise ValueError("scan_lo and scan_hi go together")
    kw = dict(
        n_cycles=n_cycles, n_bins=n_bins, bin_mz_min=bin_mz_min,
        bin_width=bin_width, slab=slab, window_len=window_len,
        with_mz=with_mz, mz_as_delta=mz_as_delta,
    )
    peaks, cycle, scanbin = store
    if peaks.device.type == "cpu":
        return extract_xic_packed(
            store, cell_start, slot_idx, query_mz, tol_ppm, cycle_start,
            scan_lo=scan_lo, scan_hi=scan_hi, **kw,
        )
    if peaks.device.type != "cuda":
        raise ValueError(f"unsupported device {peaks.device}")
    if window_len * cycle_stride > 1 << 16:
        raise ValueError("the kernel takes windows of at most 2**16 fine cycles")

    dev = peaks.device
    _check(peaks, "store.packed", torch.float32, 2, dev)
    _check(cycle, "store.cycle", torch.uint16, 1, dev)
    _check(scanbin, "store.scanbin", torch.int16, 1, dev)
    n_peaks = peaks.shape[0]
    if (
        peaks.shape[1] != 2 or n_peaks % 8 or cycle.shape[0] != n_peaks or scanbin.shape[0] != n_peaks
        or any(t.data_ptr() % 16 for t in store)
    ):
        raise ValueError("store must be 16-byte aligned planes of N rows ([N, 2], [N], [N]), N a multiple of 8")
    _check(cell_start, "cell_start", torch.int32, 3, dev)
    if cell_start.shape[1] != n_bins or cell_start.shape[2] < n_cycles + 1:
        raise ValueError(
            f"cell_start shape {tuple(cell_start.shape)} does not match "
            f"n_bins={n_bins}, n_cycles={n_cycles}"
        )
    _check(slot_idx, "slot_idx", torch.int32, 2, dev)
    B, Q = slot_idx.shape
    _check(query_mz, "query_mz", torch.float32, 2, dev)
    _check(cycle_start, "cycle_start", torch.int32, 1, dev)
    if tuple(query_mz.shape) != (B, Q) or cycle_start.shape[0] != B:
        raise ValueError("query_mz must be [B, Q] and cycle_start [B]")
    if scan_lo is not None:
        _check(scan_lo, "scan_lo", torch.int32, 1, dev)
        _check(scan_hi, "scan_hi", torch.int32, 1, dev)
        if scan_lo.shape[0] != B or scan_hi.shape[0] != B:
            raise ValueError("scan_lo and scan_hi must be [B]")

    W = window_len
    out_int = torch.empty((B, Q, W), dtype=torch.float32, device=dev)
    out_mz = torch.empty((B, Q, W), dtype=torch.float32, device=dev) if with_mz else None
    tol = np.float32(tol_ppm) * np.float32(1e-6)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.xic_launch(
        peaks.data_ptr(), cycle.data_ptr(),
        scanbin.data_ptr() if scan_lo is not None else None,
        n_peaks,
        cell_start.data_ptr(), cell_start.shape[2],
        cell_start.shape[0], n_bins, n_cycles,
        slot_idx.data_ptr(), query_mz.data_ptr(), cycle_start.data_ptr(),
        scan_lo.data_ptr() if scan_lo is not None else None,
        scan_hi.data_ptr() if scan_hi is not None else None,
        B, Q, W, slab, cycle_stride.bit_length() - 1,
        float(np.float32(1.0) - tol), float(np.float32(1.0) + tol),
        float(np.float32(bin_mz_min)), float(np.float32(bin_width)),
        int(with_mz), int(mz_as_delta),
        out_int.data_ptr(), out_mz.data_ptr() if with_mz else None, stream,
    )
    if err != 0:
        raise RuntimeError(f"xic kernel launch failed: CUDA error {err}")
    launches += 1
    return (out_int, out_mz) if with_mz else out_int
