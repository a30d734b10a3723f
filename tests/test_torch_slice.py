"""The slice end to end: the port's ``CandidateSelection`` ->
``CandidateScoring`` against the JAX drivers on a synthetic world with
decoys, carried across with ``alphadia_torch.convert``.

- candidates: every column exactly equal, but ``score``, which both
  drivers round to float16 and which may differ by one float16 step;
- a wide RT tolerance coarsens selection to stride 2: candidates exactly
  equal there too;
- PSMs: every feature within the scoring tests' float32 tolerance (2e-3
  of max(|value|, 1); 0.06 ppm for the mass errors; one bfloat16 step for
  the features that travel as bfloat16), every other column equal;
- fragments: library columns equal, observed columns within one step of
  the precision they travel in.
"""

import logging

import numpy as np
import pytest

from alphadia_torch.convert import config_from_jax, diadata_from_jax, frame_from_pandas
from alphadia_torch.search.scoring import CandidateScoring
from alphadia_torch.search.selection import CandidateSelection
from alphadia_tpu.ops.scoring import _BF16_FEATURES
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.search.scoring import FEATURE_COLUMNS
from alphadia_tpu.search.scoring import CandidateScoring as JaxScoring
from alphadia_tpu.search.scoring import ScoringConfig
from alphadia_tpu.search.selection import CandidateSelection as JaxSelection
from alphadia_tpu.search.selection import SelectionConfig
from alphadia_tpu.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia

pytest_plugins = ("torch_port_plugin",)

MASS_ERRORS = (
    "weighted_mass_deviation", "weighted_mass_error", "top_3_ms2_mass_error",
    "mean_ms2_mass_error", "mean_overlapping_mass_error",
)
BF16_STEP = 2.0**-7
F16_STEP = 2.0**-10


@pytest.fixture(scope="module")
def world():
    spectra, prec, frag = make_synthetic_dia(
        SyntheticConfig(n_peptides=300, n_windows=6, n_cycles=350, seed=21)
    )
    prec, frag = add_synthetic_decoys(prec, frag)
    jd = JaxDiaData.from_spectra(spectra, use_native=False)
    return jd, prec, frag, diadata_from_jax(jd), frame_from_pandas(prec), frame_from_pandas(frag)


def assert_candidates_equal(ours: dict, theirs):
    assert sorted(ours) == sorted(theirs.columns)
    assert len(ours["precursor_idx"]) == len(theirs) > 0
    for c in theirs.columns:
        a, b = ours[c], theirs[c].to_numpy()
        assert a.dtype == b.dtype, c
        if c == "score":
            np.testing.assert_allclose(a, b, rtol=F16_STEP, atol=1e-3)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)


@pytest.mark.parametrize("rt_tolerance", [60.0, 450.0], ids=["rt60", "rt450_coarse"])
def test_candidates_equal(world, rt_tolerance, caplog):
    jd, prec, frag, td, tprec, tfrag = world
    cfg = SelectionConfig(rt_tolerance=rt_tolerance, candidate_count=3, batch_size=1024)
    theirs = JaxSelection(jd, prec, frag, cfg)()
    with caplog.at_level(logging.INFO, logger="alphadia_torch"):
        ours = CandidateSelection(td, tprec, tfrag, config_from_jax(cfg), device="cpu")()
    coarsened = "stride 2" in caplog.text
    assert coarsened == (rt_tolerance > 100)
    assert_candidates_equal(ours, theirs)


def test_psms_and_fragments_match(world):
    jd, prec, frag, td, tprec, tfrag = world
    scfg = SelectionConfig(rt_tolerance=60.0, candidate_count=3, batch_size=1024)
    cands = JaxSelection(jd, prec, frag, scfg)()
    cfg = ScoringConfig(batch_size=512, collect_fragments=True)
    psm, frags = JaxScoring(jd, prec, frag, cfg)(cands)
    ours, ours_frags = CandidateScoring(td, tprec, tfrag, config_from_jax(cfg), device="cpu")(
        frame_from_pandas(cands)
    )

    assert len(ours["precursor_idx"]) == len(psm) > 100
    bf16 = {FEATURE_COLUMNS[i] for i in _BF16_FEATURES}
    for c in psm.columns:
        b = psm[c].to_numpy()
        a = ours[c]
        if c in MASS_ERRORS:
            np.testing.assert_allclose(a, b, rtol=0, atol=0.06, err_msg=c)
        elif c in FEATURE_COLUMNS:
            scale = np.maximum(np.abs(b.astype(np.float64)), 1.0)
            tol = BF16_STEP if c in bf16 else 2e-3
            assert (np.abs(a - b) <= tol * scale).all(), c
        elif b.dtype == object:
            assert [str(x) for x in a] == [str(x) for x in b], c
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)

    assert sorted(ours_frags) == sorted(frags.columns)
    assert len(ours_frags["mz"]) == len(frags) > 500
    for c in frags.columns:
        a, b = ours_frags[c], frags[c].to_numpy()
        assert a.dtype == b.dtype, c
        if c in ("height", "intensity"):
            np.testing.assert_allclose(a, b, rtol=BF16_STEP, atol=0, err_msg=c)
        elif c == "mass_error":
            np.testing.assert_allclose(a, b, rtol=0, atol=0.06, err_msg=c)
        elif c == "correlation":
            np.testing.assert_allclose(a, b, rtol=F16_STEP, atol=1e-3, err_msg=c)
        elif c == "mz_observed":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=c)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)
