"""What follows each calibration fit: the candidate count back to its
target; score_cutoff = 0.99 x the 1st percentile of the score (0.95 x the
3rd with optimized_peak_group_score); the RT and mobility FWHM from the
medians of the filtered precursors (NaN skipped, as pandas' ``median``;
NaN where every value is NaN, as ``mobility_fwhm`` on 3D data can be); and,
with ``search.quadrupole_fit``, the quadrupole transmission model."""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.utils.frame import n_rows
from alphadia_torch.workflow.managers.calibration_manager import CalibrationGroups
from alphadia_torch.workflow.optimizers.automatic import nan_median

logger = logging.getLogger(__name__)


class RecalibrationHandler:
    DEFAULT_FAC, DEFAULT_Q = 0.95, 3
    OPTIMIZED_FAC, OPTIMIZED_Q = 0.99, 1

    def __init__(self, config, optimization_manager, calibration_manager):
        self._config = config
        self._om = optimization_manager
        self._cm = calibration_manager

    def recalibrate(self, precursor_df_filtered: dict, fragments_df_filtered: dict) -> None:
        self._cm.fit(precursor_df_filtered, CalibrationGroups.PRECURSOR)
        self._cm.fit(fragments_df_filtered, CalibrationGroups.FRAGMENT)

        self._om.update(num_candidates=self._config["search"]["target_num_candidates"])

        score = precursor_df_filtered["score"]
        if self._config["search"]["optimized_peak_group_score"]:
            fac, q = self.DEFAULT_FAC, self.DEFAULT_Q
        else:
            fac, q = self.OPTIMIZED_FAC, self.OPTIMIZED_Q
        score_cutoff = fac * np.percentile(score, q) if len(score) else 0.0
        logger.info("score_cutoff %.3f (fac=%s, q=%s)", score_cutoff, fac, q)

        self._om.update(
            fwhm_rt=nan_median(precursor_df_filtered["cycle_fwhm"]),
            fwhm_mobility=nan_median(precursor_df_filtered["mobility_fwhm"]),
            score_cutoff=float(score_cutoff),
        )

        if self._config["search"].get("quadrupole_fit", False):
            self._fit_quadrupole(precursor_df_filtered)

    def _fit_quadrupole(self, psm_df: dict, min_multi: int = 100) -> None:
        """Fit the transmission model from the raw per-window fragment sums,
        when enough window-overlap observations exist."""
        from alphadia_torch.search.quadrupole import QuadrupoleCalibration, harvest_transmission

        data = harvest_transmission(psm_df) if n_rows(psm_df) else None
        if data is None or data["n_multi"] < min_multi:
            n = 0 if data is None else data["n_multi"]
            logger.info("quadrupole fit skipped: %d overlap observations (<%d)", n, min_multi)
            return
        quad = QuadrupoleCalibration(
            sigma=np.asarray(self._om.quad_sigma, np.float64),
            delta_mu=np.asarray(self._om.quad_delta_mu, np.float64),
        ).fit(data["mu1"], data["mu2"], data["x"], data["y"])
        self._om.update(
            quad_sigma=tuple(float(v) for v in quad.sigma),
            quad_delta_mu=tuple(float(v) for v in quad.delta_mu),
        )
        logger.info(
            "quadrupole fit (%d overlap obs): sigma=(%.3f, %.3f) delta_mu=(%.3f, %.3f)",
            data["n_multi"], quad.sigma[0], quad.sigma[1], quad.delta_mu[0], quad.delta_mu[1],
        )
