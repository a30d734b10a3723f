"""Comparisons of the port's column dicts with the JAX package's frames, at
the tolerances of ``test_torch_slice.py``:

- candidates: every column exactly equal, but ``score``, which both
  drivers round to float16 (one float16 step);
- PSM features within 2e-3 of max(|value|, 1) (0.06 ppm for the mass
  errors; one bfloat16 step for the features that travel as bfloat16),
  the candidates' ``score`` as above, every other PSM column equal.
"""

from __future__ import annotations

import numpy as np

from alphadia_tpu.ops.scoring import _BF16_FEATURES
from alphadia_tpu.search.scoring import FEATURE_COLUMNS

MASS_ERRORS = (
    "weighted_mass_deviation", "weighted_mass_error", "top_3_ms2_mass_error",
    "mean_ms2_mass_error", "mean_overlapping_mass_error",
)
BF16_STEP = 2.0**-7
F16_STEP = 2.0**-10


def sorted_rows(frame: dict, keys=("precursor_idx", "rank")) -> dict:
    order = np.lexsort([np.asarray(frame[k]) for k in reversed(keys)])
    return {k: np.asarray(v)[order] for k, v in frame.items()}


def assert_candidates_equal(ours: dict, theirs) -> None:
    """``theirs`` a pandas frame; both sorted by (precursor_idx, rank)."""
    ours = sorted_rows(ours)
    theirs = theirs.sort_values(["precursor_idx", "rank"]).reset_index(drop=True)
    assert sorted(ours) == sorted(theirs.columns)
    assert len(ours["precursor_idx"]) == len(theirs) > 0
    for c in theirs.columns:
        a, b = ours[c], theirs[c].to_numpy()
        assert a.dtype == b.dtype, c
        if c == "score":
            np.testing.assert_allclose(a, b, rtol=F16_STEP, atol=1e-3)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)


def assert_psms_match(ours: dict, theirs) -> None:
    ours = sorted_rows(ours)
    theirs = theirs.sort_values(["precursor_idx", "rank"]).reset_index(drop=True)
    assert len(ours["precursor_idx"]) == len(theirs) > 0
    bf16 = {FEATURE_COLUMNS[i] for i in _BF16_FEATURES}
    for c in theirs.columns:
        b = theirs[c].to_numpy()
        a = ours[c]
        if c in MASS_ERRORS:
            np.testing.assert_allclose(a, b, rtol=0, atol=0.06, err_msg=c)
        elif c == "score":  # the candidates' score
            np.testing.assert_allclose(a, b, rtol=F16_STEP, atol=1e-3)
        elif c in FEATURE_COLUMNS:
            scale = np.maximum(np.abs(b.astype(np.float64)), 1.0)
            tol = BF16_STEP if c in bf16 else 2e-3
            assert (np.abs(a - b) <= tol * scale).all(), c
        elif b.dtype == object:
            assert [str(x) for x in a] == [str(x) for x in b], c
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)
