"""The 4D (ion-mobility) slice end to end: the port's ``CandidateSelection``
-> ``CandidateScoring`` against the JAX drivers on a synthetic timsTOF-like
world (8 scan bins) with decoys, carried across with
``alphadia_torch.convert``.

- candidates: every integer column exactly equal, scan columns included, at
  rt 60 s and at the wide 450 s tolerance that coarsens selection to stride
  2; ``score`` within one float16 step (both drivers round it to float16);
- PSMs: every feature within the 3D slice's tolerances (2e-3 of max(|value|,
  1); 0.06 ppm for the mass errors; one bfloat16 step for the features that
  travel as bfloat16; ``mobility_observed`` and ``base_width_mobility``
  within 1e-6 relative), every other column equal; the scan features non-zero
  exactly where JAX's are;
- fragments, with every library fragment slot collected
  (``collect_unobserved_fragments``): library columns equal, observed
  columns within one step of the precision they travel in.

Before the 4D branches the port ran the 3D path on such data and gave every
candidate the dummy scan window [0, 1); the candidate test fails on that.

Run as a script, the file prints both drivers' truth shares (best candidate
within 3 cycles of the true apex) on a larger world, the reading that the
4D gates of ``chip_smoke.py`` rest on:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_slice_4d.py --peptides 6250 --windows 3
"""

import argparse
import dataclasses
import logging

import numpy as np
import pytest

from alphadia_torch.convert import config_from_jax, diadata_from_jax, frame_from_pandas
from alphadia_torch.search.scoring import CandidateScoring
from alphadia_torch.search.selection import CandidateSelection
from alphadia_tpu.ops.scoring import _BF16_FEATURES
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.search.scoring import FEATURE_COLUMNS, ScoringConfig
from alphadia_tpu.search.scoring import CandidateScoring as JaxScoring
from alphadia_tpu.search.selection import CandidateSelection as JaxSelection
from alphadia_tpu.search.selection import SelectionConfig
from alphadia_tpu.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia

pytest_plugins = ("torch_port_plugin",)

MASS_ERRORS = (
    "weighted_mass_deviation", "weighted_mass_error", "top_3_ms2_mass_error",
    "mean_ms2_mass_error", "mean_overlapping_mass_error",
)
MOBILITY = ("mobility_observed", "base_width_mobility")
SCAN_COLUMNS = ("fragment_scan_correlation", "template_scan_correlation", "mobility_fwhm") + MOBILITY
BF16_STEP = 2.0**-7
F16_STEP = 2.0**-10


@pytest.fixture(scope="module")
def world():
    spectra, prec, frag = make_synthetic_dia(
        SyntheticConfig(n_peptides=300, n_windows=6, n_cycles=350, with_mobility=True, seed=21)
    )
    prec, frag = add_synthetic_decoys(prec, frag)
    jd = JaxDiaData.from_spectra(spectra, n_scan_bins=8, use_native=False)
    return jd, prec, frag, diadata_from_jax(jd), frame_from_pandas(prec), frame_from_pandas(frag)


@pytest.mark.parametrize("rt_tolerance", [60.0, 450.0], ids=["rt60", "rt450_coarse"])
def test_candidates_equal_4d(world, rt_tolerance, caplog):
    jd, prec, frag, td, tprec, tfrag = world
    cfg = SelectionConfig(rt_tolerance=rt_tolerance, candidate_count=3, batch_size=1024)
    theirs = JaxSelection(jd, prec, frag, cfg)()
    with caplog.at_level(logging.INFO, logger="alphadia_torch"):
        ours = CandidateSelection(td, tprec, tfrag, config_from_jax(cfg), device="cpu")()
    assert ("stride 2" in caplog.text) == (rt_tolerance > 100)
    assert sorted(ours) == sorted(theirs.columns)
    assert len(ours["precursor_idx"]) == len(theirs) > 0
    for c in theirs.columns:
        a, b = ours[c], theirs[c].to_numpy()
        assert a.dtype == b.dtype, c
        if c == "score":
            np.testing.assert_allclose(a, b, rtol=F16_STEP, atol=1e-3)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)
    assert truth_share(tprec, td, ours) == truth_share(tprec, td, theirs) == 1.0
    # real scan windows, not the 3D dummy [0, 1)
    assert (ours["scan_stop"] > 1).mean() > 0.9 and (ours["scan_start"] > 0).any()
    assert (ours["scan_start"] <= ours["scan_center"]).all() and (ours["scan_center"] < ours["scan_stop"]).all()


def test_psms_and_fragments_match_4d(world):
    jd, prec, frag, td, tprec, tfrag = world
    scfg = SelectionConfig(rt_tolerance=60.0, candidate_count=3, batch_size=1024)
    cands = JaxSelection(jd, prec, frag, scfg)()
    cfg = ScoringConfig(batch_size=512, collect_fragments=True, collect_unobserved_fragments=True)
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
        elif c in MOBILITY:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=c)
        elif c in FEATURE_COLUMNS:
            scale = np.maximum(np.abs(b.astype(np.float64)), 1.0)
            tol = BF16_STEP if c in bf16 else 2e-3
            assert (np.abs(a - b) <= tol * scale).all(), c
        elif b.dtype == object:
            assert [str(x) for x in a] == [str(x) for x in b], c
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)
    for c in SCAN_COLUMNS:
        b = psm[c].to_numpy()
        np.testing.assert_array_equal(ours[c] != 0, b != 0, err_msg=c)
        assert (b != 0).mean() > 0.5, c

    assert sorted(ours_frags) == sorted(frags.columns)
    assert len(ours_frags["mz"]) == len(frags) > 500
    assert (frags["height"].to_numpy() == 0).any()  # unobserved slots are in
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


def truth_share(tprec, td, cands) -> float:
    """Share of detectable targets whose best candidate lies within 3 cycles
    of the true apex."""
    det = tprec["_truth_detectable"] & (tprec["decoy"] == 0)
    truth_cycle = np.abs(td.cycle_rt[None, :] - tprec["_truth_rt"][:, None]).argmin(1)[det]
    best = np.asarray(cands["rank"]) == 0
    at = dict(zip(np.asarray(cands["precursor_idx"])[best].tolist(), np.asarray(cands["frame_center"])[best].tolist()))
    hits = [abs(at.get(int(p), -(10**6)) - int(t)) <= 3 for p, t in zip(tprec["precursor_idx"][det], truth_cycle)]
    return float(np.mean(hits))


def test_config_from_jax_keeps_the_4d_fields():
    jax_cfg = SelectionConfig(f_mobility=0.9, min_size_mobility=3, max_size_mobility=7, peak_scan_tolerance=2)
    cfg = config_from_jax(jax_cfg)
    for name in ("f_mobility", "min_size_mobility", "max_size_mobility", "peak_scan_tolerance"):
        assert getattr(cfg, name) == getattr(jax_cfg, name), name
    assert config_from_jax(ScoringConfig(collect_unobserved_fragments=True)).collect_unobserved_fragments


def test_config_from_jax_drops_only_transport_fields():
    # the transport options have no place in the port and may go
    for jax_cfg in (
        SelectionConfig(use_pallas=False, mesh_devices=2, bench_device_time=True),
        ScoringConfig(use_pallas=False, mesh_devices=2, bench_device_time=True, transport_quant=False),
    ):
        config_from_jax(jax_cfg)

    @dataclasses.dataclass
    class LaterSelectionConfig(SelectionConfig):
        new_knob: int = 1

    with pytest.raises(ValueError, match="new_knob"):
        config_from_jax(LaterSelectionConfig())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="truth shares of the JAX and the port's 4D selection")
    ap.add_argument("--peptides", type=int, default=6250)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--cycles", type=int, default=600)
    opt = ap.parse_args()
    spectra, prec, frag = make_synthetic_dia(
        SyntheticConfig(
            n_peptides=opt.peptides, n_windows=opt.windows, n_cycles=opt.cycles,
            noise_peaks_per_spectrum=80, with_mobility=True, seed=5,
        )
    )
    prec, frag = add_synthetic_decoys(prec, frag)
    jd = JaxDiaData.from_spectra(spectra, n_scan_bins=8, use_native=False)
    td, tprec, tfrag = diadata_from_jax(jd), frame_from_pandas(prec), frame_from_pandas(frag)
    for rt in (60.0, 450.0):
        cfg = SelectionConfig(rt_tolerance=rt, candidate_count=3, batch_size=1024)
        theirs = JaxSelection(jd, prec, frag, cfg)()
        ours = CandidateSelection(td, tprec, tfrag, config_from_jax(cfg), device="cpu")()
        same = len(ours["precursor_idx"]) == len(theirs) and all(
            np.array_equal(ours[c], theirs[c].to_numpy()) for c in theirs.columns if c != "score"
        )
        print(
            f"{len(prec)} precursors, {opt.windows} windows, {opt.cycles} cycles, rt {rt:.0f} s: JAX truth share "
            f"{truth_share(tprec, td, theirs):.4f}, port {truth_share(tprec, td, ours):.4f}, candidates identical {same}"
        )
