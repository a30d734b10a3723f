"""Raw file loading and acquisition statistics: the format dispatch of
``rawdata.source.load_raw_file``, the ``DiaData`` build and a stat record.

Parsed mzML spectra are cached as ``<raw>.cache.hdf`` beside the source
(the JAX package's cache format) and read back while the cache is as new
as the source; an unreadable cache is parsed anew, one that cannot be
written is only logged."""

from __future__ import annotations

import logging
from pathlib import Path

from alphadia_torch.rawdata import DiaData, load_raw_file
from alphadia_torch.rawdata.hdf import read_alpharaw_hdf, save_spectra_hdf
from alphadia_torch.workflow.managers.base import BaseManager

logger = logging.getLogger(__name__)


class RawFileManager(BaseManager):
    def __init__(self, config=None, path=None, load_from_file=False):
        super().__init__(path, load_from_file)
        self.config = config
        if not self.is_loaded_from_file:
            self.stats: dict = {}

    def _load_with_cache(self, raw_path: str, thread_count: int):
        """XML parsing is the slow part of reading an mzML file: keep the
        spectra as HDF beside the source and reuse them while fresh."""
        src = Path(raw_path)
        if not src.name.lower().endswith((".mzml", ".mzml.gz")):
            return load_raw_file(raw_path, thread_count=thread_count)
        cache = src.parent / (src.name + ".cache.hdf")
        if cache.exists() and cache.stat().st_mtime >= src.stat().st_mtime:
            try:
                logger.info("Reusing spectra cache %s", cache.name)
                return read_alpharaw_hdf(cache, thread_count=thread_count)
            except Exception as e:
                logger.warning("spectra cache unreadable (%s); re-parsing", e)
        spectra = load_raw_file(raw_path, thread_count=thread_count)
        try:
            save_spectra_hdf(cache, spectra, thread_count=thread_count)
        except Exception as e:  # read-only directories and the like
            logger.info("spectra cache not written: %s", e)
        return spectra

    def get_dia_data_object(self, raw_path: str) -> DiaData:
        thread_count = self.config["general"]["thread_count"] if self.config else 4
        coarse_bin = self.config["tpu"]["coarse_bin_width"] if self.config else 1.0
        n_scan_bins = self.config["tpu"]["n_scan_bins"] if self.config else 8
        spectra = self._load_with_cache(raw_path, thread_count)
        dia = DiaData.from_spectra(spectra, coarse_bin_width=coarse_bin, n_scan_bins=n_scan_bins)
        self.stats = {
            "rt_limit_min": dia.rt_min,
            "rt_limit_max": dia.rt_max,
            "cycle_len": dia.n_slots,
            "n_cycles": dia.n_cycles,
            "n_peaks": dia.n_peaks,
            "has_ms1": dia.has_ms1,
            "has_mobility": dia.has_mobility,
            "quad_min_mz": dia.quad_min_mz,
            "quad_max_mz": dia.quad_max_mz,
        }
        logger.info(
            "Raw file: %d cycles x %d slots, %s peaks, RT %.0f-%.0fs, quad %.0f-%.0f",
            dia.n_cycles, dia.n_slots, f"{dia.n_peaks:,}", dia.rt_min, dia.rt_max, dia.quad_min_mz, dia.quad_max_mz,
        )
        return dia
