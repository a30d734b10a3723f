"""Column-dict schema validation: required and optional typed columns,
dtype coercion in place where numpy can cast, NaN / inf warnings (the JAX
package's ``validation/base.py`` on column dicts instead of DataFrames)."""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


class Column:
    required = False

    def __init__(self, name: str, dtype):
        self.name = name
        self.dtype = np.dtype(dtype)

    def check(self, df: dict, warn_on_critical_values: bool = False) -> None:
        if self.name not in df:
            if self.required:
                raise ValueError(f"missing required column '{self.name}'")
            return
        col = np.asarray(df[self.name])
        if self.dtype == object:
            return
        if col.dtype != self.dtype:
            try:
                if col.dtype.kind in "OUS" and self.dtype.kind != "O":
                    # pandas' astype parses numeric text; numpy casts it too,
                    # but an object column of non-numbers must fail here
                    col = np.array([float(v) for v in col]).astype(self.dtype)
                df[self.name] = col.astype(self.dtype)
            except (TypeError, ValueError) as e:
                raise ValueError(f"column '{self.name}' has dtype {col.dtype}, cannot coerce to {self.dtype}") from e
        if warn_on_critical_values and np.issubdtype(self.dtype, np.floating):
            vals = np.asarray(df[self.name])
            n_nan = int(np.isnan(vals).sum())
            n_inf = int(np.isinf(vals).sum())
            if n_nan or n_inf:
                logger.warning(f"column '{self.name}': {n_nan} NaN, {n_inf} inf values")


class Required(Column):
    required = True


class Optional(Column):
    required = False


class Schema:
    def __init__(self, name: str, columns: list[Column]):
        self.name = name
        self.columns = columns

    def validate(self, df: dict, warn_on_critical_values: bool = False) -> dict:
        if not isinstance(df, dict):
            raise TypeError(f"{self.name}: expected a column dict, got {type(df)}")
        for col in self.columns:
            col.check(df, warn_on_critical_values)
        return df
