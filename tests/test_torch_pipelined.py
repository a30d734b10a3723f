"""The port's ``PipelinedExtraction`` against the port's sequential drivers
and against the JAX package's ``PipelinedExtraction`` (the cases of
``tests/unit/test_pipelined.py``), on the CPU.

- pipelined against sequential, within the port: candidates, PSM features
  and fragment values identical (atol 0), in 3D with selection batches of
  128 and scoring chunks of 256 (chunks cut across selection batches, and
  a power-of-two tail) and in 4D;
- against JAX: candidates exactly equal (score within one float16 step),
  PSM features within ``test_torch_slice.py``'s tolerances
  (``torch_compare``);
- an empty library gives three empty frames;
- where slabs overflow, the port departs from JAX's scoring by no more than
  JAX departs from itself under another window bucket (the bounds are in
  the test's docstring).
"""

import numpy as np
import pytest

from alphadia_torch.convert import diadata_from_jax, frame_from_pandas
from alphadia_torch.search.pipelined import PipelinedExtraction
from alphadia_torch.search.scoring import FEATURE_COLUMNS, CandidateScoring, ScoringConfig
from alphadia_torch.search.selection import CandidateSelection, SelectionConfig
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.search.pipelined import PipelinedExtraction as JaxPipelined
from alphadia_tpu.search.scoring import CandidateScoring as JaxScoring
from alphadia_tpu.search.scoring import ScoringConfig as JaxScoringConfig
from alphadia_tpu.search.selection import CandidateSelection as JaxSelection
from alphadia_tpu.search.selection import SelectionConfig as JaxSelectionConfig
from alphadia_tpu.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
from torch_compare import assert_candidates_equal, assert_psms_match, sorted_rows

pytest_plugins = ("torch_port_plugin",)

FRAG_VALUES = ("height", "intensity", "mass_error", "correlation")

WORLDS = {
    # name: (world, selection kwargs, scoring batch, selection batch cap)
    "3d": (dict(n_peptides=300, n_windows=6, n_cycles=350, seed=21), dict(candidate_count=3), 256, 128),
    "4d": (
        dict(n_peptides=120, n_windows=4, n_cycles=250, seed=7, with_mobility=True),
        dict(candidate_count=2, batch_size=512), 128, 64,
    ),
}


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request):
    kw, sel_kw, score_batch, cap = WORLDS[request.param]
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(**kw))
    prec, frag = add_synthetic_decoys(prec, frag)
    jd = JaxDiaData.from_spectra(spectra, n_scan_bins=8, use_native=False)
    return dict(
        jax=(jd, prec, frag), port=(diadata_from_jax(jd), frame_from_pandas(prec), frame_from_pandas(frag)),
        sel_kw=dict(rt_tolerance=60.0, **sel_kw), score_batch=score_batch, cap=cap,
    )


def _port_pipelined(w):
    dia, prec, frag = w["port"]
    sel = SelectionConfig(**w["sel_kw"])
    score = ScoringConfig(batch_size=w["score_batch"], collect_fragments=True)
    return PipelinedExtraction(dia, prec, frag, sel, score, sel_batch_cap=w["cap"], device="cpu")()


def test_pipelined_equals_sequential(world):
    dia, prec, frag = world["port"]
    sel = SelectionConfig(**world["sel_kw"])
    score = ScoringConfig(batch_size=world["score_batch"], collect_fragments=True)
    cands_seq = CandidateSelection(dia, prec, frag, sel, device="cpu")()
    psm_seq, frag_seq = CandidateScoring(dia, prec, frag, score, device="cpu")(cands_seq)
    cands, psm, frags = _port_pipelined(world)

    a, b = sorted_rows(cands_seq), sorted_rows(cands)
    assert sorted(a) == sorted(b) and len(a["precursor_idx"]) > 100
    for c in a:
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)
    a, b = sorted_rows(psm_seq), sorted_rows(psm)
    assert len(b["precursor_idx"]) == len(a["precursor_idx"]) > 50
    np.testing.assert_array_equal(b["rank"], a["rank"])
    np.testing.assert_allclose(
        np.stack([b[f] for f in FEATURE_COLUMNS], 1), np.stack([a[f] for f in FEATURE_COLUMNS], 1), rtol=0, atol=0
    )
    key = ("precursor_idx", "rank", "mz")
    a, b = sorted_rows(frag_seq, key), sorted_rows(frags, key)
    assert len(a["mz"]) == len(b["mz"]) > 100
    for c in FRAG_VALUES:
        np.testing.assert_allclose(b[c], a[c], rtol=0, atol=0, err_msg=c)


def test_pipelined_matches_jax(world):
    jd, prec, frag = world["jax"]
    sel = JaxSelectionConfig(**world["sel_kw"])
    score = JaxScoringConfig(batch_size=world["score_batch"], collect_fragments=True)
    cands_j, psm_j, _ = JaxPipelined(jd, prec, frag, sel, score, sel_batch_cap=world["cap"])()
    cands, psm, _ = _port_pipelined(world)
    assert_candidates_equal(cands, cands_j)
    assert_psms_match(psm, psm_j)


def test_pipelined_empty_library(world):
    dia, prec, frag = world["port"]
    empty = {k: v[:0] for k, v in prec.items()}
    cands, psm, frags = PipelinedExtraction(dia, empty, frag, None, None, device="cpu")()
    assert len(cands["precursor_idx"]) == len(psm["precursor_idx"]) == len(frags["mz"]) == 0


@pytest.mark.parametrize("with_mobility", [False, True], ids=["3d", "4d"])
def test_features_do_not_depend_on_the_window_bucket(with_mobility):
    """Scoring the same candidates with window buckets W and 2W gives the
    same XIC sums and features (2e-3 of max(|value|, 1): the window
    positions round differently), also where slabs overflow (``gather_slab``
    8 here): each XIC is read from the candidate's first cycle. Read from the
    window start, as the JAX package reads it, the wider window spends the
    slab on cycles before the candidate; the per-chunk buckets of the
    pipelined driver then changed 2% of the 4D world's feature values by
    more than 1e-2 on the card."""
    kw = WORLDS["4d" if with_mobility else "3d"][0]
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(**kw))
    prec, frag = add_synthetic_decoys(prec, frag)
    jd = JaxDiaData.from_spectra(spectra, n_scan_bins=8, use_native=False)
    dia, prec, frag = diadata_from_jax(jd), frame_from_pandas(prec), frame_from_pandas(frag)
    cands = CandidateSelection(dia, prec, frag, SelectionConfig(candidate_count=2), device="cpu")()
    out = []
    for factor in (1, 2):
        scoring = CandidateScoring(dia, prec, frag, ScoringConfig(batch_size=512, gather_slab=8), device="cpu")
        geometry = scoring._candidate_geometry

        def wider(cand, geometry=geometry, factor=factor):
            geo = geometry(cand)
            geo["window_len"] *= factor
            return geo

        scoring._candidate_geometry = wider
        out.append(scoring(cands)[0])
    a, b = out
    assert len(a["precursor_idx"]) == len(b["precursor_idx"]) > 50
    for f in ("mono_ms1_intensity", "sum_ms1_intensity", "weighted_ms1_intensity"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for f in FEATURE_COLUMNS:
        scale = np.maximum(np.abs(a[f].astype(np.float64)), 1.0)
        assert (np.abs(a[f] - b[f]) <= 2e-3 * scale).all(), f


def _share_apart(ours: dict, theirs: dict, tol: float = 1e-2) -> tuple[float, float]:
    """(share of PSM keys in common, share of feature values on the common
    keys more than ``tol`` of max(|value|, 1) apart)."""
    ka = set(zip(ours["precursor_idx"].tolist(), ours["rank"].tolist()))
    kb = set(zip(theirs["precursor_idx"].tolist(), theirs["rank"].tolist()))
    common = ka & kb

    def rows(x):
        keep = np.array([k in common for k in zip(x["precursor_idx"].tolist(), x["rank"].tolist())])
        x = sorted_rows({k: np.asarray(v)[keep] for k, v in x.items()})
        return np.stack([x[f] for f in FEATURE_COLUMNS], 1).astype(np.float64)

    a, b = rows(ours), rows(theirs)
    apart = np.abs(a - b) > tol * np.maximum(np.abs(b), 1.0)
    return len(common) / len(ka | kb), float(apart.mean())


@pytest.mark.parametrize("with_mobility", [False, True], ids=["3d", "4d"])
def test_overflowing_slabs_depart_from_jax_as_far_as_its_own_window_bucket(with_mobility):
    """Where slabs overflow (``gather_slab`` 8 here), the port departs from
    the JAX package's sequential scoring: the port reads each XIC from the
    candidate's first cycle, JAX from the window start. JAX's own features
    then depend on the window bucket: the same candidates scored by JAX with
    W and 2W differ in 0.497 (3D) and 0.494 (4D) of feature values by more
    than 1e-2 of max(|value|, 1); the port at W against JAX at W in 0.535
    and 0.565; the port does not move with W
    (``test_features_do_not_depend_on_the_window_bucket``). Pinned: JAX's
    own W-dependence above 0.4; the port against JAX no more than 0.1 above
    it; PSM keys in common at least 0.98 (0.993 and 0.991). At the default
    slab no slab of these worlds overflows and the port equals JAX within
    ``torch_compare``'s tolerances (``test_pipelined_matches_jax``)."""
    kw = WORLDS["4d" if with_mobility else "3d"][0]
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(**kw))
    prec, frag = add_synthetic_decoys(prec, frag)
    jd = JaxDiaData.from_spectra(spectra, n_scan_bins=8, use_native=False)
    cands_j = JaxSelection(jd, prec, frag, JaxSelectionConfig(candidate_count=2))()

    jax_psms = []
    for factor in (1, 2):
        scoring = JaxScoring(jd, prec, frag, JaxScoringConfig(batch_size=512, gather_slab=8))
        geometry = scoring._candidate_geometry

        def wider(cand, geometry=geometry, factor=factor):
            geo = geometry(cand)
            geo["window_len"] *= factor
            return geo

        scoring._candidate_geometry = wider
        jax_psms.append(frame_from_pandas(scoring(cands_j)[0]))
    dia, pp, pf = diadata_from_jax(jd), frame_from_pandas(prec), frame_from_pandas(frag)
    psm = CandidateScoring(dia, pp, pf, ScoringConfig(batch_size=512, gather_slab=8), device="cpu")(
        frame_from_pandas(cands_j)
    )[0]

    keys_jax, apart_jax = _share_apart(jax_psms[1], jax_psms[0])
    keys, apart = _share_apart(psm, jax_psms[0])
    assert keys_jax >= 0.98 and keys >= 0.98, (keys_jax, keys)
    assert apart_jax > 0.4, apart_jax
    assert apart <= apart_jax + 0.1, (apart, apart_jax)
