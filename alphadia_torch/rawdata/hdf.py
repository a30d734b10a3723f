"""Raw files in HDF: alphaRaw's layout and the spectra cache.

- ``read_alpharaw_hdf(path)``: the spectra cache (root attribute ``format``
  ``SPECTRA_FORMAT``: one dataset per ``SpectrumData`` field), else
  alphaRaw's layout, a ``spectrum_df`` and a ``peak_df`` column group at the
  root or one group deep (``ms_data``). Columns go by their alphaRaw or
  alphabase names; RT is in minutes unless ``spectrum_df``'s ``rt_unit``
  attribute says ``second`` (a run past 10 h after the conversion is
  warned about); per-peak mobility (1/K0) makes the run 4D.
- ``save_spectra_hdf(path, data)``: the cache, each array under deflate
  level 1.

The files go through the port's own HDF5 reader and writer
(``utils/hdf5``); the format string is the JAX package's, so that either
package reads the other's cache.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from alphadia_torch.rawdata.source import SpectrumData
from alphadia_torch.utils import hdf5

logger = logging.getLogger(__name__)

SPECTRA_FORMAT = "alphadia_tpu_spectra"
_CACHE_KEYS = ("rt", "ms_level", "isolation_lower_mz", "isolation_upper_mz", "peak_start_idx", "peak_stop_idx", "mz",
               "intensity")


def _find_group(f, name: str):
    """A column group at the root or one group deep."""
    if name in f:
        return f[name]
    for key in f:
        node = f[key]
        if isinstance(node, hdf5.Group) and name in node:
            return node[name]
    return None


def _col(group, *names):
    for n in names:
        if n in group:
            return group[n][:]
    return None


def read_alpharaw_hdf(path: str | Path, thread_count: int = 1) -> SpectrumData:
    """The spectra of an alphaRaw ``.hdf`` or of a spectra cache; chunks
    are decompressed on ``thread_count`` threads."""
    with hdf5.File(path, threads=thread_count) as f:
        if f.attrs.get("format", "") == SPECTRA_FORMAT:
            return SpectrumData(**{k: f[k][:] for k in f})

        spec = _find_group(f, "spectrum_df")
        peak = _find_group(f, "peak_df")
        if spec is None or peak is None:
            raise ValueError(f"{path}: no spectrum_df/peak_df groups found (alphaRaw layout)")

        rt = _col(spec, "rt", "rt_values")
        rt_unit = str(spec.attrs.get("rt_unit", ""))
        ms_level = _col(spec, "ms_level")
        iso_lo = _col(spec, "isolation_lower_mz", "precursor_mz_lower")
        iso_hi = _col(spec, "isolation_upper_mz", "precursor_mz_upper")
        start = _col(spec, "peak_start_idx", "peak_start_idxes")
        stop = _col(spec, "peak_stop_idx", "peak_stop_idxes")
        mz = _col(peak, "mz", "mz_values")
        inten = _col(peak, "intensity", "intensity_values")
        # timsTOF layouts carry per-peak ion mobility (1/K0)
        mobility = _col(peak, "mobility", "mobility_values", "inv_ion_mobility")

    for name, arr in (
        ("rt", rt), ("ms_level", ms_level), ("isolation bounds", iso_lo),
        ("peak offsets", start), ("mz", mz), ("intensity", inten),
    ):
        if arr is None:
            raise ValueError(f"{path}: missing {name} column")

    rt_s = np.asarray(rt, np.float64)
    if rt_s.size == 0:
        raise ValueError(f"{path}: empty spectrum table")
    # the layout stores RT in minutes; an explicit rt_unit attribute wins
    if rt_unit == "second":
        pass
    elif rt_unit in ("", "minute"):
        rt_s = rt_s * 60.0
        if rt_s.max() > 36000:  # > 10 h after conversion
            logger.warning(
                f"{path}: RT range is {rt_s.max() / 3600:.1f} h after the minutes->seconds conversion the alphaRaw "
                "layout implies — if this file stores seconds, set the spectrum_df attribute rt_unit='second'"
            )
    else:
        raise ValueError(f"{path}: unknown rt_unit attribute {rt_unit!r}")

    if iso_hi is None:
        iso_hi = iso_lo
    ms_level = np.asarray(ms_level, np.uint8)
    iso_lo = np.where(ms_level == 1, -1.0, np.asarray(iso_lo, np.float32))
    iso_hi = np.where(ms_level == 1, -1.0, np.asarray(iso_hi, np.float32))

    data = SpectrumData(
        rt=rt_s.astype(np.float32),
        ms_level=ms_level,
        isolation_lower_mz=iso_lo.astype(np.float32),
        isolation_upper_mz=iso_hi.astype(np.float32),
        peak_start_idx=np.asarray(start, np.int64),
        peak_stop_idx=np.asarray(stop, np.int64),
        mz=np.asarray(mz, np.float32),
        intensity=np.asarray(inten, np.float32),
        mobility=np.asarray(mobility, np.float32) if mobility is not None else None,
    )
    logger.info(
        f"HDF: {data.n_spectra} spectra, {len(data.mz):,} peaks{' (4D, mobility)' if data.has_mobility else ''} "
        f"from {path}"
    )
    return data


def save_spectra_hdf(path: str | Path, data: SpectrumData, thread_count: int = 1) -> None:
    """The spectra cache: one dataset per field (``mobility`` where 4D)."""
    root = hdf5.Group({"format": SPECTRA_FORMAT})
    for k in _CACHE_KEYS + (("mobility",) if data.has_mobility else ()):
        root.create_dataset(k, getattr(data, k))
    hdf5.write(path, root, threads=thread_count)
