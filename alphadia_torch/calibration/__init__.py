from alphadia_torch.calibration.estimator import (
    CalibrationEstimator,
    CalibrationModelProvider,
    calibration_model_provider,
)
from alphadia_torch.calibration.models import LinearRegression, LOESSRegression, construct_polynomial_regression

__all__ = [
    "CalibrationEstimator",
    "CalibrationModelProvider",
    "LOESSRegression",
    "LinearRegression",
    "calibration_model_provider",
    "construct_polynomial_regression",
]
