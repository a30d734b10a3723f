"""Regression models for property calibration.

``LOESSRegression``: n_kernels local polynomial fits blended by tricubic
weights; kernel intervals placed uniformly over the x-range or by data
density and widened by ``kernel_size`` (default 2.0: each kernel's data
slice is extended by half an interval on each side, so neighbouring kernels
overlap and the blended curve stays smooth on noisy data); open-ended edge
kernels for extrapolation; +1e-6 kernel epsilon; 0.1/99.9-percentile
outlier trim; fewer kernels or a lower polynomial degree for small data.
It is numpy, as in the JAX package, and computes the same to the last bit.

``LinearRegression`` and ``construct_polynomial_regression`` are numpy
least squares with scikit-learn's ``fit`` / ``predict`` surface (the port
does not depend on scikit-learn): ordinary least squares with an intercept
fitted on centred data, and ``PolynomialFeatures(degree, include_bias=True)``
followed by least squares without an intercept.
"""

from __future__ import annotations

from itertools import combinations_with_replacement

import numpy as np


def _as_2d(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return x.reshape(-1, 1) if x.ndim == 1 else x


class LinearRegression:
    """scikit-learn's ``LinearRegression``: minimum-norm least squares, the
    intercept from the centred data."""

    def __init__(self, fit_intercept: bool = True):
        self.fit_intercept = fit_intercept
        self.coef_: np.ndarray | None = None
        self.intercept_: float | np.ndarray = 0.0

    def fit(self, x, y) -> "LinearRegression":
        X = _as_2d(x)
        y = np.asarray(y, dtype=np.float64)
        if self.fit_intercept:
            x_mean, y_mean = X.mean(axis=0), y.mean(axis=0)
            coef = np.linalg.lstsq(X - x_mean, y - y_mean, rcond=None)[0]
            self.intercept_ = y_mean - x_mean @ coef
        else:
            coef = np.linalg.lstsq(X, y, rcond=None)[0]
            self.intercept_ = 0.0
        self.coef_ = coef.T
        return self

    def predict(self, x) -> np.ndarray:
        return _as_2d(x) @ self.coef_.T + self.intercept_

    def get_params(self, deep: bool = True) -> dict:
        return {"fit_intercept": self.fit_intercept}


class PolynomialRegression:
    """``Pipeline([PolynomialFeatures(degree, include_bias=True),
    LinearRegression(fit_intercept=False)])``: the monomials in
    scikit-learn's order (by degree, then by ``combinations_with_replacement``
    of the features)."""

    def __init__(self, degree: int = 2):
        self.degree = degree
        self.linear = LinearRegression(fit_intercept=False)

    def _features(self, x) -> np.ndarray:
        X = _as_2d(x)
        cols = [
            np.prod(X[:, list(c)], axis=1) if c else np.ones(len(X))
            for d in range(self.degree + 1)
            for c in combinations_with_replacement(range(X.shape[1]), d)
        ]
        return np.stack(cols, axis=1)

    def fit(self, x, y) -> "PolynomialRegression":
        self.linear.fit(self._features(x), y)
        return self

    def predict(self, x) -> np.ndarray:
        return self.linear.predict(self._features(x))

    def get_params(self, deep: bool = True) -> dict:
        return {"degree": self.degree}


def construct_polynomial_regression(degree: int = 2) -> PolynomialRegression:
    return PolynomialRegression(degree)


def _tricubic(u: np.ndarray, epsilon: float = 1e-6) -> np.ndarray:
    """Tricubic kernel on |u| <= 1 (+epsilon inside), zero outside."""
    mask = np.abs(u) <= 1.0
    return mask * ((1 - np.clip(np.abs(u), 0.0, 1.0) ** 3) ** 3 + epsilon)


class LOESSRegression:
    """Locally weighted polynomial regression, sklearn-style fit/predict.

    Kernel placement: density intervals of ``n // n_kernels`` sorted points extended by
    ``(interval * kernel_size - interval) // 2`` on each side, kernel
    center/halfwidth = mean / max-abs-deviation of the slice.
    """

    def __init__(
        self,
        n_kernels: int = 6,
        kernel_size: float = 2.0,
        polynomial_degree: int = 2,
        *,
        uniform: bool = False,
    ):
        self.n_kernels = n_kernels
        self.kernel_size = kernel_size
        self.polynomial_degree = polynomial_degree
        self.uniform = uniform
        # configured complexity: each fit() restores these before the
        # small-data reduction, so one tiny early batch cannot permanently
        # degrade later large-data refits of a reused estimator
        self._cfg_n_kernels = n_kernels
        self._cfg_polynomial_degree = polynomial_degree
        self.centers: np.ndarray | None = None
        self.halfwidths: np.ndarray | None = None
        self.beta: np.ndarray | None = None

    # ------------------------------------------------------------------
    def _design(self, x: np.ndarray) -> np.ndarray:
        return np.stack(
            [x ** d for d in range(self.polynomial_degree + 1)], axis=1
        )

    def _weights(self, x: np.ndarray) -> np.ndarray:
        """[n, K] blend weights; edge kernels open-ended; rows sum to 1."""
        K = len(self.centers)
        u = (x[:, None] - self.centers[None, :]) / np.maximum(
            self.halfwidths[None, :], 1e-12
        )
        w = _tricubic(u)
        # open edges: first kernel covers everything left, last everything right
        w[:, 0] = np.where(x < self.centers[0], 1.0, w[:, 0])
        w[:, -1] = np.where(x > self.centers[-1], 1.0, w[:, -1])
        s = w.sum(axis=1, keepdims=True)
        # fall back to nearest kernel where all weights vanish (possible
        # only in interior gaps wider than the widened kernels)
        nearest = np.argmin(np.abs(u), axis=1)
        empty = s[:, 0] <= 0
        if empty.any():
            w[empty] = 0.0
            w[empty, nearest[empty]] = 1.0
            s = w.sum(axis=1, keepdims=True)
        return w / s

    # ------------------------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray) -> "LOESSRegression":
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        if len(x) < 2:
            raise ValueError("At least two datapoints required for fitting.")

        # reduce complexity for small data, starting
        # from the CONFIGURED complexity each fit
        # getattr: estimators unpickled from pre-fix checkpoints lack _cfg_*
        self.n_kernels = getattr(self, "_cfg_n_kernels", self.n_kernels)
        self.polynomial_degree = getattr(
            self, "_cfg_polynomial_degree", self.polynomial_degree
        )
        dof = (1 + self.polynomial_degree) * self.n_kernels
        if len(x) < dof:
            self.n_kernels = max(len(x) // (1 + self.polynomial_degree), 1)
        dof = (1 + self.polynomial_degree) * self.n_kernels
        if len(x) < dof:
            self.polynomial_degree = max(len(x) - 1, 0)

        # outlier trim: strict 0.1/99.9 percentile, guarded so that tiny
        # inputs keep >= 2 points
        if len(x) >= 8:
            lo, hi = np.percentile(x, [0.1, 99.9])
            mask = (x > lo) & (x < hi)
            if mask.sum() >= 2:
                x, y = x[mask], y[mask]

        order = np.argsort(x)
        xs = x[order]
        K = self.n_kernels

        if self.uniform:
            self._place_uniform(xs)
            # too few points in some uniform kernel -> density placement
            counts = np.array(
                [
                    np.sum(
                        (xs >= c - h) & (xs <= c + h)
                    )
                    for c, h in zip(self.centers, self.halfwidths)
                ]
            )
            if np.any(counts < (1 + self.polynomial_degree)):
                self._place_by_density(xs)
        else:
            self._place_by_density(xs)

        w = self._weights(x)  # [n, K]
        X = self._design(x)  # [n, D]
        D = X.shape[1]
        self.beta = np.zeros((D, K))
        for k in range(K):
            wk = w[:, k]
            A = (X.T * wk) @ X
            try:
                loadings = np.linalg.solve(A, X.T)
            except np.linalg.LinAlgError:
                loadings = np.linalg.pinv(A) @ X.T
            self.beta[:, k] = (loadings * wk) @ y
        return self

    def _place_uniform(self, xs: np.ndarray) -> None:
        """Uniform intervals widened by kernel_size."""
        K = self.n_kernels
        minval, maxval = xs[0], xs[-1]
        interval = max((maxval - minval) / K, 1e-12)
        start = (
            minval
            + np.arange(K) * interval
            - (interval / 2) * (self.kernel_size - 1)
        )
        stop = start + interval + interval * (self.kernel_size - 1)
        self.centers = (start + stop) / 2
        self.halfwidths = np.maximum((stop - start) / 2, 1e-12)

    def _place_by_density(self, xs: np.ndarray) -> None:
        """Equal-count intervals widened by kernel_size: interval = n // K points per kernel,
        extended by (interval * kernel_size - interval) // 2 points on
        each side; center/halfwidth = mean / max |x - mean| of the
        extended slice."""
        K = self.n_kernels
        n = len(xs)
        interval = max(n // K, 1)
        ext = int((interval * self.kernel_size - interval) // 2)
        self.centers = np.zeros(K)
        self.halfwidths = np.zeros(K)
        for k in range(K):
            s = max(0, k * interval - ext)
            e = min(n, (k + 1) * interval + ext)
            seg = xs[s:e] if e > s else xs[max(0, s - 1) : s + 1]
            self.centers[k] = seg.mean()
            self.halfwidths[k] = max(np.max(np.abs(seg - self.centers[k])), 1e-12)

    # ------------------------------------------------------------------
    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        w = self._weights(x)
        X = self._design(x)
        per_kernel = X @ self.beta  # [n, K]
        return (per_kernel * w).sum(axis=1)

    def get_params(self, deep: bool = True) -> dict:
        return {
            "n_kernels": self.n_kernels,
            "kernel_size": self.kernel_size,
            "polynomial_degree": self.polynomial_degree,
            "uniform": self.uniform,
        }
