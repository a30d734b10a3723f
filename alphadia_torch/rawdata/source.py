"""Host-side raw spectrum container (the normalized product of a reader)
and the dispatch on a raw file's format."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

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


SUPPORTED = ".mzML, .mzML.gz, .hdf (alphaRaw), .d (Bruker TDF), .npz"


def load_raw_file(path: str | Path, thread_count: int = 4) -> SpectrumData:
    """Read a raw file by its extension: ``.mzML`` (plain or gzipped),
    ``.hdf`` / ``.hdf5`` / ``.h5`` (alphaRaw's layout or the spectra cache),
    a Bruker ``.d`` directory and ``.npz`` (``save_npz``), each reader on
    ``thread_count`` threads where it has any; other formats raise as
    unsupported."""
    path = Path(path)
    name = path.name.lower()
    suffix = path.suffix.lower()
    if suffix == ".mzml" or name.endswith(".mzml.gz"):
        from alphadia_torch.rawdata.mzml import read_mzml

        return read_mzml(path, thread_count=thread_count)
    if suffix in (".hdf", ".hdf5", ".h5"):
        from alphadia_torch.rawdata.hdf import read_alpharaw_hdf

        return read_alpharaw_hdf(path, thread_count=thread_count)
    if suffix == ".d":
        from alphadia_torch.rawdata.bruker_tdf import read_bruker_d

        return read_bruker_d(path, thread_count=thread_count)
    if suffix == ".npz":
        return load_npz(path)
    raise ValueError(
        f"Unsupported raw file format '{suffix}' ({path}). Supported: {SUPPORTED}; convert other vendor "
        "formats (.raw/.wiff) to mzML first."
    )


def save_npz(path: str | Path, data: SpectrumData) -> None:
    arrays = dict(
        rt=data.rt,
        ms_level=data.ms_level,
        isolation_lower_mz=data.isolation_lower_mz,
        isolation_upper_mz=data.isolation_upper_mz,
        peak_start_idx=data.peak_start_idx,
        peak_stop_idx=data.peak_stop_idx,
        mz=data.mz,
        intensity=data.intensity,
    )
    if data.has_mobility:
        arrays["mobility"] = data.mobility
    np.savez_compressed(path, **arrays)


def load_npz(path: str | Path) -> SpectrumData:
    with np.load(path) as z:
        return SpectrumData(**{k: z[k] for k in z.files})
