"""Raw file loading and acquisition statistics: the format dispatch of
``rawdata.source.load_raw_file``, the ``DiaData`` build and a stat record.

The JAX package caches parsed mzML spectra as HDF beside the source; that
cache needs an HDF5 writer and comes with the HDF slice of the port: each
search parses its mzML file anew."""

from __future__ import annotations

import logging

from alphadia_torch.rawdata import DiaData, load_raw_file
from alphadia_torch.workflow.managers.base import BaseManager

logger = logging.getLogger(__name__)


class RawFileManager(BaseManager):
    def __init__(self, config=None, path=None, load_from_file=False):
        super().__init__(path, load_from_file)
        self.config = config
        if not self.is_loaded_from_file:
            self.stats: dict = {}

    def get_dia_data_object(self, raw_path: str) -> DiaData:
        thread_count = self.config["general"]["thread_count"] if self.config else 4
        coarse_bin = self.config["tpu"]["coarse_bin_width"] if self.config else 1.0
        n_scan_bins = self.config["tpu"]["n_scan_bins"] if self.config else 8
        spectra = load_raw_file(raw_path, thread_count=thread_count)
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
