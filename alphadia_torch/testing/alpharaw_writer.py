"""Raw files in alphaRaw's HDF layout, written by the port's HDF5 writer.

``save_alpharaw_hdf(path, spectra)`` writes what alphaRaw converts vendor
files into: ``ms_data/spectrum_df`` (``rt`` in minutes with the attribute
``rt_unit = "minute"``, ``ms_level``, ``isolation_lower_mz`` /
``isolation_upper_mz``, ``peak_start_idx`` / ``peak_stop_idx``) and
``ms_data/peak_df`` (``mz``, ``intensity``, and ``mobility`` for 4D
spectra), every column under deflate level 1. ``rawdata.hdf.read_alpharaw_hdf``
reads it back to the same arrays.
"""

from __future__ import annotations

import numpy as np

from alphadia_torch.rawdata.source import SpectrumData
from alphadia_torch.utils import hdf5


def save_alpharaw_hdf(path, spectra: SpectrumData, thread_count: int = 1) -> None:
    root = hdf5.Group()
    ms = root.create_group("ms_data")
    spec = ms.create_group("spectrum_df", {"rt_unit": "minute"})
    spec.create_dataset("rt", spectra.rt.astype(np.float64) / 60.0)
    spec.create_dataset("ms_level", spectra.ms_level.astype(np.int8))
    spec.create_dataset("isolation_lower_mz", spectra.isolation_lower_mz.astype(np.float64))
    spec.create_dataset("isolation_upper_mz", spectra.isolation_upper_mz.astype(np.float64))
    spec.create_dataset("peak_start_idx", spectra.peak_start_idx.astype(np.int64))
    spec.create_dataset("peak_stop_idx", spectra.peak_stop_idx.astype(np.int64))
    peak = ms.create_group("peak_df")
    peak.create_dataset("mz", spectra.mz)
    peak.create_dataset("intensity", spectra.intensity)
    if spectra.has_mobility:
        peak.create_dataset("mobility", spectra.mobility)
    hdf5.write(path, root, threads=thread_count)
