"""Automatic search-parameter optimizers.

- proposal = automatic_update_factor x ci(df, automatic_update_percentile_range);
- convergence needs >= 3 history rows and min_steps optimizations; without
  try_narrower_values: stop when the feature improved < 10% against both
  of the last two rows; with it: stop when the feature dropped by more
  than maximal_decrease against both, or the parameter changed < 5%;
- optimum row = the first row of the largest feature (NaN skipped, as
  pandas' ``idxmax``), or, with favour_narrower_optimum, the first row of
  the smallest parameter within maximum_decrease_from_maximum of the
  largest feature;
- at convergence the optimization manager takes the parameter, classifier
  version, score cutoff and FWHM values of the optimum row, and the lock
  its batch index;
- ``skip`` converges an optimizer after min_steps + max_skips consecutive
  skips.

The feature: precursor_proportion_detected for RT, ms2 and mobility; the
mean isotope_intensity_correlation (NaN skipped, as pandas' ``mean``) for
ms1. The history is a column dict, one row per step.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np

from alphadia_torch.utils.frame import n_rows
from alphadia_torch.workflow.managers.calibration_manager import CalibrationEstimators, CalibrationGroups

logger = logging.getLogger(__name__)

HISTORY_COLUMNS = ("parameter", "classifier_version", "score_cutoff", "fwhm_rt", "fwhm_mobility", "batch_idx")


def nan_mean(values) -> float:
    """pandas' ``Series.mean``: NaN skipped, NaN when nothing is left,
    computed in the column's own float type, as pandas does."""
    values = np.asarray(values)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.nanmean(values)) if len(values) else float("nan")


def nan_median(values) -> float:
    """pandas' ``Series.median``: NaN skipped, NaN when nothing is left,
    computed in the column's own float type."""
    values = np.asarray(values)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.nanmedian(values)) if len(values) else float("nan")


def first_argmax(values) -> int:
    """pandas' ``idxmax`` on a default index: the first row of the largest
    value, NaN skipped; raises when every value is NaN."""
    values = np.asarray(values, np.float64)
    if not len(values) or np.isnan(values).all():
        raise ValueError("Encountered all NA values")
    return int(np.nanargmax(values))


class BaseOptimizer:
    parameter_name: str

    def __init__(self, config, optimization_manager, calibration_manager, fdr_manager):
        self._config = config
        self._optimization_manager = optimization_manager
        self._calibration_manager = calibration_manager
        self._fdr_manager = fdr_manager

    def step(self, precursors_df, fragments_df):  # pragma: no cover - interface
        raise NotImplementedError

    def skip(self):
        pass

    def proceed_with_insufficient_precursors(self, precursors_df, fragments_df):
        pass


class AutomaticOptimizer(BaseOptimizer):
    _estimator_group_name: str
    _estimator_name: str
    _feature_name: str

    def __init__(self, initial_parameter: float, config, optimization_manager, calibration_manager, fdr_manager, optlock):
        super().__init__(config, optimization_manager, calibration_manager, fdr_manager)
        self._optlock = optlock
        self.history_df: dict = {k: np.zeros(0) for k in (*HISTORY_COLUMNS, self._feature_name)}
        self._optimization_manager.update(**{self.parameter_name: initial_parameter})
        self.has_converged = False
        self._num_prev_optimizations = 0
        self._num_consecutive_skips = 0

        opt_cfg = config["optimization"][self.parameter_name]
        self.update_factor = opt_cfg["automatic_update_factor"]
        self.update_percentile_range = opt_cfg["automatic_update_percentile_range"]
        self._try_narrower_values = opt_cfg["try_narrower_values"]
        self._maximal_decrease = opt_cfg["maximal_decrease"]
        self._favour_narrower_optimum = opt_cfg["favour_narrower_optimum"]
        self._maximum_decrease_from_maximum = opt_cfg["maximum_decrease_from_maximum"]

    def step(self, precursors_df: dict, fragments_df: dict) -> None:
        if self.has_converged:
            return
        self._num_consecutive_skips = 0
        self._num_prev_optimizations += 1
        self._update_history(precursors_df, fragments_df)

        if self._just_converged:
            self.has_converged = True
            self._update_workflow()
            logger.log(
                25, "%-15s: optimal %.4f after %d searches", self.parameter_name,
                getattr(self._optimization_manager, self.parameter_name), n_rows(self.history_df),
            )
        else:
            df = precursors_df if self._estimator_group_name == CalibrationGroups.PRECURSOR else fragments_df
            new_parameter = self._propose_new_parameter(df)
            self._optimization_manager.update(**{self.parameter_name: new_parameter})
            logger.info("%-15s: continuing with %.4f", self.parameter_name, new_parameter)

    def skip(self) -> None:
        self._num_consecutive_skips += 1
        if self._batch_substantially_bigger:
            self.has_converged = True
            self._update_workflow()

    def proceed_with_insufficient_precursors(self, precursors_df, fragments_df) -> None:
        if n_rows(precursors_df):
            self._update_history(precursors_df, fragments_df)
            self._update_workflow()

    def _propose_new_parameter(self, df: dict) -> float:
        est = self._calibration_manager.get_estimator(self._estimator_group_name, self._estimator_name)
        proposal = self.update_factor * est.ci(df, self.update_percentile_range)
        if proposal <= 0:
            # ci() is 0 when the calibration fit failed (is_fitted stays
            # False): a zero tolerance would find nothing on the next pass
            current = getattr(self._optimization_manager, self.parameter_name)
            logger.warning(
                "%s: calibration yielded no usable CI; keeping current tolerance %.4f", self.parameter_name, current
            )
            return float(current)
        return proposal

    def _update_history(self, precursors_df, fragments_df) -> None:
        om = self._optimization_manager
        row = {
            "parameter": getattr(om, self.parameter_name),
            self._feature_name: self._get_feature_value(precursors_df, fragments_df),
            "classifier_version": self._fdr_manager.current_version,
            "score_cutoff": om.score_cutoff,
            "fwhm_rt": om.fwhm_rt,
            "fwhm_mobility": om.fwhm_mobility,
            "batch_idx": self._optlock.batch_idx,
        }
        self.history_df = {k: np.append(v, np.float64(row[k])) for k, v in self.history_df.items()}

    @property
    def _batch_substantially_bigger(self) -> bool:
        return (
            self._num_prev_optimizations >= self._config["calibration"]["min_steps"]
            and self._num_consecutive_skips > self._config["calibration"]["max_skips"]
        )

    @property
    def _just_converged(self) -> bool:
        if n_rows(self.history_df) < 3:
            return False
        feat = self.history_df[self._feature_name]
        last, second, third = feat[-1], feat[-2], feat[-3]
        min_steps_reached = self._num_prev_optimizations >= self._config["calibration"]["min_steps"]
        with np.errstate(divide="ignore", invalid="ignore"):
            if self._try_narrower_values:
                decreased = (last - second) / abs(second) < -self._maximal_decrease and (
                    last - third
                ) / abs(third) < -self._maximal_decrease
                params = self.history_df["parameter"]
                param_static = abs((params[-1] - params[-2]) / params[-2]) < 0.05
                return bool(min_steps_reached and (decreased or param_static))
            not_improved = (last - second) / abs(second) < 0.1 and (last - third) / abs(third) < 0.1
        return bool(min_steps_reached and not_improved)

    def _find_index_of_optimum(self) -> int:
        n = n_rows(self.history_df)
        if n == 0:
            raise ValueError(f"Optimizer {self.parameter_name} has no history")
        if n == 1:
            return 0
        feat = self.history_df[self._feature_name]
        if self._favour_narrower_optimum:
            fmax = np.nanmax(feat) if not np.isnan(feat).all() else np.nan
            threshold = fmax - self._maximum_decrease_from_maximum * abs(fmax)
            within = np.nonzero(feat > threshold)[0]
            if not len(within):
                return first_argmax(feat)
            return int(within[first_argmax(-self.history_df["parameter"][within])])
        return first_argmax(feat)

    def _update_workflow(self) -> None:
        i = self._find_index_of_optimum()
        h = self.history_df
        self._optimization_manager.update(**{self.parameter_name: h["parameter"][i]})
        self._optimization_manager.update(
            classifier_version=int(h["classifier_version"][i]),
            score_cutoff=h["score_cutoff"][i],
            fwhm_rt=h["fwhm_rt"][i],
            fwhm_mobility=h["fwhm_mobility"][i],
        )
        self._optlock.batch_idx = int(h["batch_idx"][i])

    def _get_feature_value(self, precursors_df, fragments_df):  # pragma: no cover
        raise NotImplementedError


class AutomaticRTOptimizer(AutomaticOptimizer):
    parameter_name = "rt_error"
    _estimator_group_name = CalibrationGroups.PRECURSOR
    _estimator_name = CalibrationEstimators.RT
    _feature_name = "precursor_proportion_detected"

    def _get_feature_value(self, precursors_df, fragments_df):
        return n_rows(precursors_df) / max(self._optlock.total_elution_groups, 1)


class AutomaticMS2Optimizer(AutomaticOptimizer):
    parameter_name = "ms2_error"
    _estimator_group_name = CalibrationGroups.FRAGMENT
    _estimator_name = CalibrationEstimators.MZ
    _feature_name = "precursor_proportion_detected"

    def _get_feature_value(self, precursors_df, fragments_df):
        return n_rows(precursors_df) / max(self._optlock.total_elution_groups, 1)


class AutomaticMS1Optimizer(AutomaticOptimizer):
    parameter_name = "ms1_error"
    _estimator_group_name = CalibrationGroups.PRECURSOR
    _estimator_name = CalibrationEstimators.MZ
    _feature_name = "mean_isotope_intensity_correlation"

    def _get_feature_value(self, precursors_df, fragments_df):
        return nan_mean(precursors_df["isotope_intensity_correlation"])


class AutomaticMobilityOptimizer(AutomaticOptimizer):
    parameter_name = "mobility_error"
    _estimator_group_name = CalibrationGroups.PRECURSOR
    _estimator_name = CalibrationEstimators.MOBILITY
    _feature_name = "precursor_proportion_detected"

    def _get_feature_value(self, precursors_df, fragments_df):
        return n_rows(precursors_df) / max(self._optlock.total_elution_groups, 1)
