"""Wrapper of the scan-resolved extraction kernel (``csrc/scan_cells.cu``).

``extract_xic_4d_cuda`` computes what ``ops/xic.extract_xic_4d`` computes
(the [B, Q, S, W] per-scan-bin XICs and, with ``with_mz``, the m/z delta
plane), and ``extract_scan_profile_cuda`` what ``ops/xic.
extract_scan_profile`` computes (the [B, Q, S] scan profiles of a cycle
window), from the ``PeakStore`` of ``DiaData.device_arrays``: its m/z and
intensity and its scan-bin plane. A cell is the peaks between two
consecutive ``cell_start`` edges, so a strided ``cell_start`` (the coarse
view) works unchanged. ``cell_start`` is int32, or int64 for a store of
2**31 entries or more; any other type raises on every device.

On CPU tensors each runs the plain version; on CUDA tensors it launches the
kernel or raises: S * W past what a warp's shared memory holds, a type or
shape the kernel does not take, or a launch the kernel refuses. The
arguments are checked alike on both devices, bar the store's layout and the
shared memory, which only the kernel needs.

The kernel is built with nvcc at first use into ``build/alphadia_torch/``
(``utils/cxx.build_library``: a shared library with a plain C interface,
loaded with ctypes). ``launches`` counts kernel launches. Under a profiler
(``utils/profiling``) each call is a span, ``ops.xic_4d`` or
``ops.scan_profile``, with a pair of timing events on the card's stream.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from alphadia_torch.ops.xic import extract_scan_profile, extract_xic_4d
from alphadia_torch.ops.xic_cuda import NVCC_FLAGS, _check, _nvcc
from alphadia_torch.utils.cxx import build_library
from alphadia_torch.utils.profiling import span

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "scan_cells.cu"

launches = 0  # kernel launches since import (or since a caller reset it)

_lib = None
_lock = threading.Lock()


def build() -> Path:
    """Compile ``csrc/scan_cells.cu`` with nvcc (once per source content);
    return the .so path."""
    return build_library(SOURCE, NVCC_FLAGS, "libscan_cells", "the scan-resolved kernel", cc=_nvcc())


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, LL, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
            lib.scan_cells_launch.argtypes = [
                P, P, LL,  # peaks, scanbin, n_peaks
                P, I, LL, I, I, I,  # cell_start, index_bytes, row_len, n_slots, n_bins, n_cycles
                P, P, P, P,  # slot_idx, query_mz, cycle_start, cycle_stop
                I, I, I, I, I,  # B, Q, S, W, slab
                F, F, F, F,  # lo_factor, hi_factor, bin_mz_min, bin_width
                I, P, P, P,  # with_mz, out_int, out_mz, stream
            ]
            lib.scan_cells_launch.restype = I
            lib.scan_cells_smem_bytes.argtypes = [I, I, I, I]
            lib.scan_cells_smem_bytes.restype = LL
            lib.scan_cells_smem_limit.argtypes = []
            lib.scan_cells_smem_limit.restype = I
            _lib = lib
        return _lib


def _checked(store, cell_start, slot_idx, query_mz, cycles, *, n_bins, n_cycles, n_scan_bins, window_len, slab):
    """Check what both paths take; return the device."""
    index_type = getattr(cell_start, "dtype", type(cell_start).__name__)
    if index_type not in (torch.int32, torch.int64):
        raise TypeError(f"cell_start must be a torch.int32 or torch.int64 tensor, got {index_type}")
    if n_scan_bins < 1 or window_len < 1 or slab < 0:
        raise ValueError(f"n_scan_bins and window_len must be >= 1 and slab >= 0, got {n_scan_bins}, {window_len}, {slab}")
    peaks, _, scanbin = store
    dev = peaks.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _check(peaks, "store.packed", torch.float32, 2, dev)
    _check(scanbin, "store.scanbin", torch.int16, 1, dev)
    if peaks.shape[1] != 2 or scanbin.shape[0] != peaks.shape[0]:
        raise ValueError("store.packed must be [N, 2] and store.scanbin [N]")
    _check(cell_start, "cell_start", cell_start.dtype, 3, dev)
    if cell_start.shape[1] != n_bins or cell_start.shape[2] < n_cycles + 1:
        raise ValueError(
            f"cell_start shape {tuple(cell_start.shape)} does not match n_bins={n_bins}, n_cycles={n_cycles}"
        )
    _check(slot_idx, "slot_idx", torch.int32, 2, dev)
    _check(query_mz, "query_mz", torch.float32, 2, dev)
    if query_mz.shape != slot_idx.shape:
        raise ValueError("query_mz must be [B, Q] as slot_idx is")
    for name, t in cycles.items():
        _check(t, name, torch.int32, 1, dev)
        if t.shape[0] != slot_idx.shape[0]:
            raise ValueError(f"{name} must be [B]")
    return dev


def _launch(store, cell_start, slot_idx, query_mz, tol_ppm, cycle_start, cycle_stop, *,
            n_cycles, n_bins, bin_mz_min, bin_width, n_scan_bins, window_len, slab, with_mz):
    """The kernel on CUDA tensors (checked by ``_checked``): f32[B, Q, S, W]
    planes, the m/z delta plane second with ``with_mz``."""
    global launches
    peaks, _, scanbin = store
    dev = peaks.device
    n_peaks = peaks.shape[0]
    if n_peaks % 8 or peaks.data_ptr() % 16 or scanbin.data_ptr() % 16:
        raise ValueError("store must be 16-byte aligned planes of N rows ([N, 2], [N]), N a multiple of 8")
    B, Q = slot_idx.shape
    S, W = n_scan_bins, window_len
    lib = _library()
    tol = np.float32(tol_ppm) * np.float32(1e-6)
    # the launch and the device queries inside it act on the current
    # device: make it the tensors' card
    with torch.cuda.device(dev):
        need = lib.scan_cells_smem_bytes(S, W, int(with_mz), cell_start.element_size())
        limit = lib.scan_cells_smem_limit()
        if need > limit:
            raise ValueError(
                f"{S} scan bins x {W} cells{' with the m/z plane' if with_mz else ''} need {need} B of shared "
                f"memory a warp; the card gives a block at most {limit} B"
            )
        out_int = torch.empty((B, Q, S, W), dtype=torch.float32, device=dev)
        out_mz = torch.empty((B, Q, S, W), dtype=torch.float32, device=dev) if with_mz else None
        err = lib.scan_cells_launch(
            peaks.data_ptr(), scanbin.data_ptr(), n_peaks,
            cell_start.data_ptr(), cell_start.element_size(), cell_start.shape[2],
            cell_start.shape[0], n_bins, n_cycles,
            slot_idx.data_ptr(), query_mz.data_ptr(), cycle_start.data_ptr(),
            cycle_stop.data_ptr() if cycle_stop is not None else None,
            B, Q, S, W, slab,
            float(np.float32(1.0) - tol), float(np.float32(1.0) + tol),
            float(np.float32(bin_mz_min)), float(np.float32(bin_width)),
            int(with_mz), out_int.data_ptr(), out_mz.data_ptr() if with_mz else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"scan-cells kernel launch failed ({cell_start.dtype} cell index): CUDA error {err}")
    launches += 1
    return out_int, out_mz


def extract_xic_4d_cuda(
    store,  # PeakStore (DiaData.device_arrays)
    cell_start: torch.Tensor,  # i32 or i64[n_slots, n_bins, n_cycles+1], fine or strided
    slot_idx: torch.Tensor,  # i32[B, Q]
    query_mz: torch.Tensor,  # f32[B, Q]
    tol_ppm: float,
    cycle_start: torch.Tensor,  # i32[B]
    *,
    n_cycles: int,
    n_bins: int,
    bin_mz_min: float,
    bin_width: float,
    n_scan_bins: int,
    slab: int = 256,
    window_len: int = 64,
    with_mz: bool = False,
):
    """Dense 4D XICs f32[B, Q, S, W] (and the m/z delta plane with
    ``with_mz``), as ``ops/xic.extract_xic_4d``."""
    with span("ops.xic_4d", slot_idx.device):
        kw = dict(n_cycles=n_cycles, n_bins=n_bins, bin_mz_min=bin_mz_min, bin_width=bin_width,
                  n_scan_bins=n_scan_bins, slab=slab)
        dev = _checked(store, cell_start, slot_idx, query_mz, {"cycle_start": cycle_start}, n_bins=n_bins,
                       n_cycles=n_cycles, n_scan_bins=n_scan_bins, window_len=window_len, slab=slab)
        if dev.type == "cpu":
            return extract_xic_4d(
                store.packed[:, 0], store.packed[:, 1], store.scanbin, cell_start, slot_idx, query_mz, tol_ppm,
                cycle_start, window_len=window_len, with_mz=with_mz, **kw,
            )
        out_int, out_mz = _launch(store, cell_start, slot_idx, query_mz, tol_ppm, cycle_start, None,
                                  window_len=window_len, with_mz=with_mz, **kw)
        return (out_int, out_mz) if with_mz else out_int


def extract_scan_profile_cuda(
    store,  # PeakStore (DiaData.device_arrays)
    cell_start: torch.Tensor,  # i32 or i64[n_slots, n_bins, n_cycles+1]
    slot_idx: torch.Tensor,  # i32[B, Q]
    query_mz: torch.Tensor,  # f32[B, Q]
    tol_ppm: float,
    cycle_lo: torch.Tensor,  # i32[B] window start (inclusive)
    cycle_hi: torch.Tensor,  # i32[B] window stop (exclusive)
    *,
    n_cycles: int,
    n_bins: int,
    bin_mz_min: float,
    bin_width: float,
    n_scan_bins: int,
    slab: int = 256,
):
    """Mobility scan profiles f32[B, Q, S] over the cycle window
    [cycle_lo, cycle_hi), as ``ops/xic.extract_scan_profile``."""
    with span("ops.scan_profile", slot_idx.device):
        kw = dict(n_cycles=n_cycles, n_bins=n_bins, bin_mz_min=bin_mz_min, bin_width=bin_width,
                  n_scan_bins=n_scan_bins, slab=slab)
        dev = _checked(store, cell_start, slot_idx, query_mz, {"cycle_lo": cycle_lo, "cycle_hi": cycle_hi},
                       n_bins=n_bins, n_cycles=n_cycles, n_scan_bins=n_scan_bins, window_len=1, slab=slab)
        if dev.type == "cpu":
            return extract_scan_profile(
                store.packed[:, 0], store.packed[:, 1], store.scanbin, cell_start, slot_idx, query_mz, tol_ppm,
                cycle_lo, cycle_hi, **kw,
            )
        out, _ = _launch(store, cell_start, slot_idx, query_mz, tol_ppm, cycle_lo, cycle_hi,
                         window_len=1, with_mz=False, **kw)
        return out.reshape(out.shape[:3])
