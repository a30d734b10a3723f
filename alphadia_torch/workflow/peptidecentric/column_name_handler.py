"""Which columns the drivers read: the calibrated column of a property
once its estimator is fitted, else the library column."""

from __future__ import annotations

from alphadia_torch.constants.keys import CalibCols
from alphadia_torch.workflow.managers.calibration_manager import (
    CalibrationEstimators,
    CalibrationGroups,
    CalibrationManager,
)


class ColumnNameHandler:
    def __init__(
        self,
        calibration_manager: CalibrationManager,
        *,
        dia_data_has_ms1: bool,
        dia_data_has_mobility: bool,
    ):
        self._groups = calibration_manager.groups
        self._has_ms1 = dia_data_has_ms1
        self._has_mobility = dia_data_has_mobility

    def _fitted(self, group: str, name: str) -> bool:
        est = self._groups.get(group, {}).get(name)
        return est is not None and est.is_fitted

    def get_precursor_mz_column(self) -> str:
        if self._has_ms1 and self._fitted(
            CalibrationGroups.PRECURSOR, CalibrationEstimators.MZ
        ):
            return CalibCols.MZ_CALIBRATED
        return CalibCols.MZ_LIBRARY

    def get_fragment_mz_column(self) -> str:
        if self._fitted(CalibrationGroups.FRAGMENT, CalibrationEstimators.MZ):
            return CalibCols.MZ_CALIBRATED
        return CalibCols.MZ_LIBRARY

    def get_rt_column(self) -> str:
        if self._fitted(CalibrationGroups.PRECURSOR, CalibrationEstimators.RT):
            return CalibCols.RT_CALIBRATED
        return CalibCols.RT_LIBRARY

    def get_mobility_column(self) -> str:
        if self._has_mobility and self._fitted(
            CalibrationGroups.PRECURSOR, CalibrationEstimators.MOBILITY
        ):
            return CalibCols.MOBILITY_CALIBRATED
        return CalibCols.MOBILITY_LIBRARY
