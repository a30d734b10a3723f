"""Targeted optimizers: shrink toward a tolerance the user set.

Proposal = targeted_update_factor x max(ci(df, percentile), target);
converged when the proposal is at most the target after min_steps; the
classifier version is taken at every step.
"""

from __future__ import annotations

import logging

from alphadia_torch.workflow.managers.calibration_manager import CalibrationEstimators, CalibrationGroups
from alphadia_torch.workflow.optimizers.automatic import BaseOptimizer

logger = logging.getLogger(__name__)


class TargetedOptimizer(BaseOptimizer):
    _estimator_group_name: str
    _estimator_name: str

    def __init__(
        self, initial_parameter: float, target_parameter: float, config, optimization_manager, calibration_manager,
        fdr_manager,
    ):
        super().__init__(config, optimization_manager, calibration_manager, fdr_manager)
        self._optimization_manager.update(**{self.parameter_name: initial_parameter})
        self.target_parameter = target_parameter
        opt_cfg = config["optimization"][self.parameter_name]
        self.update_factor = opt_cfg["targeted_update_factor"]
        self.update_percentile_range = opt_cfg["targeted_update_percentile_range"]
        self.has_converged = False
        self._num_prev_optimizations = 0

    def _propose_new_parameter(self, df: dict) -> float:
        est = self._calibration_manager.get_estimator(self._estimator_group_name, self._estimator_name)
        return self.update_factor * max(est.ci(df, self.update_percentile_range), self.target_parameter)

    def step(self, precursors_df: dict, fragments_df: dict) -> None:
        if self.has_converged:
            return
        self._num_prev_optimizations += 1
        df = precursors_df if self._estimator_group_name == CalibrationGroups.PRECURSOR else fragments_df
        new_parameter = self._propose_new_parameter(df)
        min_steps_reached = self._num_prev_optimizations >= self._config["calibration"]["min_steps"]
        just_converged = new_parameter <= self.target_parameter and min_steps_reached
        self._optimization_manager.update(**{self.parameter_name: new_parameter})
        self._optimization_manager.update(classifier_version=self._fdr_manager.current_version)
        if just_converged:
            self.has_converged = True
            logger.info("%-15s: %.4f <= %.4f", self.parameter_name, new_parameter, self.target_parameter)

    def proceed_with_insufficient_precursors(self, precursors_df, fragments_df):
        self._optimization_manager.update(**{self.parameter_name: self.target_parameter})


class TargetedRTOptimizer(TargetedOptimizer):
    parameter_name = "rt_error"
    _estimator_group_name = CalibrationGroups.PRECURSOR
    _estimator_name = CalibrationEstimators.RT


class TargetedMS2Optimizer(TargetedOptimizer):
    parameter_name = "ms2_error"
    _estimator_group_name = CalibrationGroups.FRAGMENT
    _estimator_name = CalibrationEstimators.MZ


class TargetedMS1Optimizer(TargetedOptimizer):
    parameter_name = "ms1_error"
    _estimator_group_name = CalibrationGroups.PRECURSOR
    _estimator_name = CalibrationEstimators.MZ


class TargetedMobilityOptimizer(TargetedOptimizer):
    parameter_name = "mobility_error"
    _estimator_group_name = CalibrationGroups.PRECURSOR
    _estimator_name = CalibrationEstimators.MOBILITY
