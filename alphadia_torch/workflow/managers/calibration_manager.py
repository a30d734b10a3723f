"""Calibration manager: estimator groups for precursor and fragment
properties.

Groups ``precursor`` (mz, rt, mobility) and ``fragment`` (mz); LOESS with
2 kernels for m/z (on the ppm scale) and 6 for RT (kernel_size 2.0,
polynomial degree 2); fitted on the filtered PSMs, predicted onto PSM and
library frames (column dicts) as the ``*_calibrated`` columns.
"""

from __future__ import annotations

import logging

from alphadia_torch.calibration import CalibrationEstimator, LOESSRegression
from alphadia_torch.utils.frame import n_rows
from alphadia_torch.workflow.managers.base import BaseManager

logger = logging.getLogger(__name__)


class CalibrationGroups:
    PRECURSOR = "precursor"
    FRAGMENT = "fragment"


class CalibrationEstimators:
    MZ = "mz"
    RT = "rt"
    MOBILITY = "mobility"


def _default_estimators(has_ms1: bool, has_mobility: bool):
    groups: dict[str, dict[str, CalibrationEstimator]] = {
        CalibrationGroups.PRECURSOR: {},
        CalibrationGroups.FRAGMENT: {},
    }
    if has_ms1:
        groups[CalibrationGroups.PRECURSOR][CalibrationEstimators.MZ] = (
            CalibrationEstimator(
                "mz",
                LOESSRegression(n_kernels=2),
                ["mz_library"],
                ["mz_observed"],
                ["mz_calibrated"],
                transform_deviation=1e6,
            )
        )
    groups[CalibrationGroups.PRECURSOR][CalibrationEstimators.RT] = (
        CalibrationEstimator(
            "rt",
            LOESSRegression(n_kernels=6),
            ["rt_library"],
            ["rt_observed"],
            ["rt_calibrated"],
        )
    )
    if has_mobility:
        groups[CalibrationGroups.PRECURSOR][CalibrationEstimators.MOBILITY] = (
            CalibrationEstimator(
                "mobility",
                LOESSRegression(n_kernels=2),
                ["mobility_library"],
                ["mobility_observed"],
                ["mobility_calibrated"],
            )
        )
    groups[CalibrationGroups.FRAGMENT][CalibrationEstimators.MZ] = (
        CalibrationEstimator(
            "mz",
            LOESSRegression(n_kernels=2),
            ["mz_library"],
            ["mz_observed"],
            ["mz_calibrated"],
            transform_deviation=1e6,
        )
    )
    return groups


class CalibrationManager(BaseManager):
    def __init__(
        self,
        path=None,
        load_from_file=False,
        has_ms1: bool = True,
        has_mobility: bool = False,
    ):
        super().__init__(path, load_from_file)
        if self.is_loaded_from_file:
            return
        self.groups = _default_estimators(has_ms1, has_mobility)

    # ------------------------------------------------------------------
    def get_estimator(self, group: str, name: str) -> CalibrationEstimator | None:
        return self.groups.get(group, {}).get(name)

    @property
    def is_fitted(self) -> bool:
        prec = self.groups[CalibrationGroups.PRECURSOR]
        return all(e.is_fitted for e in prec.values()) and all(
            e.is_fitted for e in self.groups[CalibrationGroups.FRAGMENT].values()
        )

    def fit(self, df: dict, group: str):
        for name, est in self.groups[group].items():
            if n_rows(df) < 2:
                logger.warning("calibration %s.%s: too few rows", group, name)
                continue
            est.fit(df)
            if est.metrics:
                logger.info(
                    "calibration %s.%s: accuracy %.4g, precision %.4g",
                    group, name, est.metrics["median_accuracy"], est.metrics["median_precision"],
                )

    def predict(self, df: dict, group: str) -> None:
        for est in self.groups[group].values():
            if est.is_fitted:
                est.predict(df)

    def fit_predict(self, df: dict, group: str) -> None:
        self.fit(df, group)
        self.predict(df, group)
