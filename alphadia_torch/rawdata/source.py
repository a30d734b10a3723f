"""Host-side raw spectrum container (the normalized product of a reader)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SpectrumData:
    """Normalized spectra of one raw file (host memory)."""

    rt: np.ndarray  # f32[n_spectra], seconds
    ms_level: np.ndarray  # u8[n_spectra]
    isolation_lower_mz: np.ndarray  # f32[n_spectra], -1 for MS1
    isolation_upper_mz: np.ndarray  # f32[n_spectra], -1 for MS1
    peak_start_idx: np.ndarray  # i64[n_spectra]
    peak_stop_idx: np.ndarray  # i64[n_spectra]
    mz: np.ndarray  # f32[n_peaks], ascending within each spectrum
    intensity: np.ndarray  # f32[n_peaks]
    mobility: np.ndarray | None = None  # f32[n_peaks] or None (3D data)

    @property
    def n_spectra(self) -> int:
        return len(self.rt)

    @property
    def has_mobility(self) -> bool:
        return self.mobility is not None and len(self.mobility) == len(self.mz)

    def is_ms1_dia(self) -> bool:
        """Whether MS1 spectra recur with a constant period."""
        ms1_idx = np.nonzero(self.ms_level == 1)[0]
        if len(ms1_idx) < 2:
            return False
        return len(np.unique(np.diff(ms1_idx))) == 1

    def drop_ms1(self) -> "SpectrumData":
        """Remove all MS1 spectra (used when MS1 does not follow the cycle)."""
        return self.select(self.ms_level > 1)

    def select(self, mask_or_idx) -> "SpectrumData":
        """Subset spectra, rebuilding the flat peak arrays."""
        arr = np.asarray(mask_or_idx)
        idx = np.nonzero(arr)[0] if arr.dtype == bool else arr
        counts = (self.peak_stop_idx[idx] - self.peak_start_idx[idx]).astype(np.int64)
        new_start = np.zeros(len(idx), dtype=np.int64)
        if len(idx) > 1:
            np.cumsum(counts[:-1], out=new_start[1:])
        total = int(counts.sum())
        # flat source index = start[spectrum] + offset within the spectrum
        src = (
            np.repeat(self.peak_start_idx[idx], counts)
            + np.arange(total, dtype=np.int64)
            - np.repeat(new_start, counts)
        )
        return SpectrumData(
            rt=self.rt[idx],
            ms_level=self.ms_level[idx],
            isolation_lower_mz=self.isolation_lower_mz[idx],
            isolation_upper_mz=self.isolation_upper_mz[idx],
            peak_start_idx=new_start,
            peak_stop_idx=new_start + counts,
            mz=self.mz[src],
            intensity=self.intensity[src],
            mobility=self.mobility[src] if self.has_mobility else None,
        )
