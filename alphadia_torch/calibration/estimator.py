"""Property calibration estimator.

- models the deviation of a target column (observed) from an input column
  (library), optionally on a relative scale (``transform_deviation=1e6``
  for ppm);
- ``predict`` writes the calibrated column, float32, into the frame (a
  column dict) in place;
- ``calc_deviation`` returns [observed, calibrated (explained), residual]
  deviations and the input value per row;
- ``ci(df, p)`` is the mean of the absolute percentile bounds of the
  residual deviation over the central p-interval: the quantity that drives
  the tolerance proposals;
- metrics: median |calibrated| (accuracy) and median |residual| (precision).
"""

from __future__ import annotations

import logging
import pickle

import numpy as np

from alphadia_torch.calibration.models import (
    LinearRegression,
    LOESSRegression,
    construct_polynomial_regression,
)

logger = logging.getLogger(__name__)


class CalibrationEstimator:
    def __init__(
        self,
        name: str,
        function,
        input_columns: list[str],
        target_columns: list[str],
        output_columns: list[str],
        transform_deviation: float | str | None = None,
    ):
        self.name = name
        self.function = function
        self.input_columns = input_columns
        self.target_columns = target_columns
        self.output_columns = output_columns
        self.transform_deviation = float(transform_deviation) if transform_deviation is not None else None
        self.is_fitted = False
        self.metrics: dict[str, float] | None = None

    def __repr__(self) -> str:
        return f"<Calibration {self.name}, fit={self.is_fitted}>"

    def fit(self, df: dict) -> np.ndarray:
        missing = [c for c in self.input_columns + self.target_columns if c not in df]
        if missing:
            logger.warning("calibration %s: missing columns %s", self.name, missing)
            return np.zeros(len(self.input_columns))
        x = np.asarray(df[self.input_columns[0]], np.float64)
        y = np.asarray(df[self.target_columns[0]], np.float64)
        try:
            self.function.fit(x, y)
            self.is_fitted = True
        except Exception as e:
            logger.warning("calibration %s failed: %s", self.name, e)
            return np.zeros(len(self.input_columns))
        self.metrics = self._get_metrics(df)
        return np.array([self.ci(df, 0.95)])

    def predict(self, df: dict, inplace: bool = True):
        if not self.is_fitted:
            logger.warning("calibration %s is not fitted, cannot predict", self.name)
            return None
        calibrated = self.function.predict(np.asarray(df[self.input_columns[0]], np.float64))
        if inplace:
            df[self.output_columns[0]] = calibrated.astype(np.float32)
            return None
        return calibrated

    def calc_deviation(self, df: dict) -> np.ndarray:
        x = np.asarray(df[self.input_columns[0]], np.float64)
        y = np.asarray(df[self.target_columns[0]], np.float64)
        calibrated = self.function.predict(x)
        observed_dev = y - x
        calibrated_dev = calibrated - x
        if self.transform_deviation is not None:
            observed_dev = observed_dev / x * self.transform_deviation
            calibrated_dev = calibrated_dev / x * self.transform_deviation
        residual_dev = observed_dev - calibrated_dev
        return np.stack([observed_dev, calibrated_dev, residual_dev, x], axis=1)

    def _get_metrics(self, df: dict) -> dict[str, float]:
        dev = self.calc_deviation(df)
        return {
            "median_accuracy": float(np.median(np.abs(dev[:, 1]))),
            "median_precision": float(np.median(np.abs(dev[:, 2]))),
        }

    def ci(self, df: dict, ci: float = 0.95) -> float:
        if not 0 < ci < 1:
            raise ValueError("Confidence interval must be between 0 and 1")
        if not self.is_fitted:
            return 0.0
        pct = [100 * (1 - ci) / 2, 100 * (1 + ci) / 2]
        residual = self.calc_deviation(df)[:, 2]
        return float(np.mean(np.abs(np.percentile(residual, pct))))

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @classmethod
    def from_file(cls, path: str) -> "CalibrationEstimator":
        with open(path, "rb") as f:
            return pickle.load(f)


class CalibrationModelProvider:
    def __init__(self):
        self.model_dict: dict[str, object] = {}

    def register_model(self, name: str, template) -> None:
        self.model_dict[name] = template

    def get_model(self, name: str):
        if name not in self.model_dict:
            raise KeyError(f"unknown calibration model {name}")
        return self.model_dict[name]


calibration_model_provider = CalibrationModelProvider()
calibration_model_provider.register_model("LOESSRegression", LOESSRegression)
calibration_model_provider.register_model("LinearRegression", LinearRegression)
calibration_model_provider.register_model("PolynomialRegression", construct_polynomial_regression)
