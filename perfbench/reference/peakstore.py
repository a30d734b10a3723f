# Frozen copy of alphadia_torch/rawdata/peakstore.py, lines 1-183, at commit b5dd55e, imports
# rewritten to this package; the plain reference of the benchmark. Edits below
# the copy are marked "reference:".
"""reference: the numpy builder alone. The peak-store builder of ``csrc/peakstore.cpp``, bound with ctypes, and
its plain numpy version.

Both sort one raw file's peaks by (cycle slot, coarse m/z bin, cycle),
duplicate the peaks within ``ghost`` Th of a bin edge into the neighbouring
bin, and build the cell index; within a cell the peaks keep their
spectrum's order (m/z ascending, ghosts in their source peak's place), the
order of the JAX package's native builder. They return the same arrays,
byte for byte:

- ``peak_mz`` f32, ``peak_intensity`` f32, ``peak_is_ghost`` bool and
  ``peak_scanbin`` i32 (0 for 3D data), each followed by ``PAD`` entries
  (m/z +inf, the rest 0);
- ``cell_start`` [n_slots, n_bins, n_cycles + 1], the first stored peak of
  each cell and, last, the end of each (slot, bin) row: int32 while the
  stored entries and their padding stay below ``INDEX32_LIMIT`` (2**31),
  int64 past it (:func:`cell_index_dtype`). The JAX package's builders
  always write int32, whose offsets wrap past 2**31 stored entries.

The C++ builder is a counting sort on ``threads`` threads (the output does
not depend on their count), built at first use (``utils/cxx``); without a
compiler it raises. It holds the outputs and an int64 offset per cell; the
numpy builder also holds a key and an index per stored peak.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


PAD = 1024
INDEX32_LIMIT = 2**31  # stored entries + PAD below it: an int32 cell index


class PeakStoreArrays(NamedTuple):
    peak_mz: np.ndarray
    peak_intensity: np.ndarray
    peak_is_ghost: np.ndarray
    peak_scanbin: np.ndarray
    cell_start: np.ndarray  # int32, or int64 past INDEX32_LIMIT (cell_index_dtype)


def cell_index_dtype(total: int) -> type:
    """The cell index's type for ``total`` stored entries: int32 while
    ``total + PAD`` stays below ``INDEX32_LIMIT``, else int64."""
    return np.int32 if total + PAD < INDEX32_LIMIT else np.int64


def _checked(mz, intensity, scanbin, spec_start, n_slots, n_cycles, n_bins, bin_width):
    """The arrays as the builders read them, and the number of spectra;
    raises ValueError for arrays or a grid that do not fit together."""
    mz = np.ascontiguousarray(mz, np.float32)
    intensity = np.ascontiguousarray(intensity, np.float32)
    scanbin = None if scanbin is None else np.ascontiguousarray(scanbin, np.int32)
    n_peaks = len(mz)
    if len(intensity) != n_peaks or (scanbin is not None and len(scanbin) != n_peaks):
        raise ValueError("mz, intensity and scanbin must have one entry a peak")
    spec_start = np.ascontiguousarray(spec_start, np.int64)
    n_spectra = len(spec_start) - 1
    if n_spectra < 0 or spec_start[0] != 0 or spec_start[-1] != n_peaks or (np.diff(spec_start) < 0).any():
        raise ValueError("spec_start must rise from 0 to the number of peaks, one entry a spectrum and one more")
    if n_slots < 1 or n_cycles < 1 or n_bins < 1 or not bin_width > 0:
        raise ValueError("n_slots, n_cycles, n_bins and bin_width must be positive")
    if n_spectra > n_slots * n_cycles:
        raise ValueError(f"{n_spectra} spectra do not fit {n_slots} slots x {n_cycles} cycles")
    return mz, intensity, scanbin, spec_start, n_spectra


def build_peak_store_numpy(
    mz, intensity, spec_start, n_slots: int, n_cycles: int, bin_mz_min: float, bin_width: float, n_bins: int,
    ghost: float, scanbin=None,
) -> PeakStoreArrays:
    """The plain version of :func:`build_peak_store`: a lexsort by cell key
    and source peak."""
    mz, inten, scanbin, spec_start, n_spectra = _checked(mz, intensity, scanbin, spec_start, n_slots, n_cycles,
                                                         n_bins, bin_width)
    spec_of_peak = np.repeat(np.arange(n_spectra, dtype=np.int64), np.diff(spec_start))
    cycle_of_peak = spec_of_peak // n_slots
    slot_of_peak = spec_of_peak % n_slots

    def bin_of(x):
        return np.clip(((x - bin_mz_min) / bin_width).astype(np.int64), 0, n_bins - 1)

    with np.errstate(invalid="ignore"):
        mz64 = mz.astype(np.float64)
        bin_of_peak = bin_of(mz64)
        up = bin_of(mz64 + ghost)
        dn = bin_of(mz64 - ghost)
    ghosts_up = np.nonzero(up != bin_of_peak)[0]
    ghosts_dn = np.nonzero(dn != bin_of_peak)[0]

    def with_ghosts(a):
        return np.concatenate([a, a[ghosts_up], a[ghosts_dn]])

    all_bin = np.concatenate([bin_of_peak, up[ghosts_up], dn[ghosts_dn]])
    key = (with_ghosts(slot_of_peak) * n_bins + all_bin) * n_cycles + with_ghosts(cycle_of_peak)
    # within a cell by source peak: m/z ascending, ghosts in their place
    order = np.lexsort((with_ghosts(np.arange(len(mz))), key))
    is_ghost = np.arange(len(key)) >= len(mz)

    n_cells = n_slots * n_bins * n_cycles
    cell_off = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(np.bincount(key, minlength=n_cells), out=cell_off[1:])
    # trailing column: end of the last cycle of each (slot, bin) row
    cs = cell_off[:-1].reshape(n_slots, n_bins, n_cycles)
    ends = cell_off[1:].reshape(n_slots, n_bins, n_cycles)[:, :, -1:]
    scan = with_ghosts(scanbin) if scanbin is not None else np.zeros(len(key), np.int32)
    return PeakStoreArrays(
        np.concatenate([with_ghosts(mz)[order], np.full(PAD, np.inf, np.float32)]),
        np.concatenate([with_ghosts(inten)[order], np.zeros(PAD, np.float32)]),
        np.concatenate([is_ghost[order], np.zeros(PAD, bool)]),
        np.concatenate([scan[order], np.zeros(PAD, np.int32)]),
        np.concatenate([cs, ends], axis=2).astype(cell_index_dtype(int(cell_off[-1]))),
    )
