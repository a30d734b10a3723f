"""The drivers' mesh branches: selection and scoring with every batch split
across two devices (``devices=["cpu", "cpu"]``, ``mesh_devices=2``), and
selection across seven.

- Against the port on one device: the candidates, the PSMs and the
  fragments exactly equal (integers and features at atol 0), 3D (at rt 60 s
  and at the wide 450 s tolerance that coarsens selection to stride 2) and
  4D;
- against the JAX package's drivers with ``mesh_devices=2`` (its mesh
  branch, on the suite's virtual 8-device CPU mesh), at the tolerances of
  ``tests/test_torch_slice.py`` and ``tests/test_torch_slice_4d.py``;
- ``PipelinedExtraction`` over two devices returns the sequential drivers'
  result (it falls back to them, as JAX's does under a mesh);
- ``config_from_jax`` carries ``mesh_devices``.
"""

import numpy as np
import pytest

from alphadia_torch.convert import config_from_jax, diadata_from_jax, frame_from_pandas
from alphadia_torch.parallel import shard_ops
from alphadia_torch.search.pipelined import PipelinedExtraction
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
BF16_STEP = 2.0**-7
F16_STEP = 2.0**-10
TWO = ["cpu", "cpu"]


@pytest.fixture(scope="module", params=["3d", "4d"])
def world(request):
    mobility = request.param == "4d"
    spectra, prec, frag = make_synthetic_dia(
        SyntheticConfig(n_peptides=300, n_windows=6, n_cycles=350, with_mobility=mobility, seed=21)
    )
    prec, frag = add_synthetic_decoys(prec, frag)
    jd = JaxDiaData.from_spectra(spectra, n_scan_bins=8, use_native=False)
    return jd, prec, frag, diadata_from_jax(jd), frame_from_pandas(prec), frame_from_pandas(frag)


def assert_exactly_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for c in a:
        assert a[c].dtype == b[c].dtype, c
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)


@pytest.mark.parametrize("n_devices, batch_size", [(2, 512), (7, 448)], ids=["two", "seven"])
@pytest.mark.parametrize("rt_tolerance", [60.0, 450.0], ids=["rt60", "rt450_coarse"])
def test_sharded_selection_equals_one_device(world, rt_tolerance, n_devices, batch_size):
    """Seven devices split the last batch (152 of the 600 precursors)
    unevenly: its last shard runs past the precursors, into zero rows whose
    outputs are dropped."""
    _, _, _, td, tprec, tfrag = world
    cfg = config_from_jax(
        SelectionConfig(rt_tolerance=rt_tolerance, candidate_count=3, batch_size=batch_size, mesh_devices=n_devices)
    )
    launches = shard_ops.launches
    one = CandidateSelection(td, tprec, tfrag, cfg, device="cpu")()
    selection = CandidateSelection(td, tprec, tfrag, cfg, devices=["cpu"] * n_devices)
    assert len(selection._mesh()) == n_devices
    two = selection()
    assert len(one["precursor_idx"]) > 500
    assert_exactly_equal(two, one)
    assert shard_ops.launches == launches  # no kernel on the CPU: the plain version ran on each shard


def test_sharded_scoring_equals_one_device(world):
    _, _, _, td, tprec, tfrag = world
    cands = CandidateSelection(td, tprec, tfrag, config_from_jax(SelectionConfig(batch_size=512)), device="cpu")()
    cfg = config_from_jax(ScoringConfig(batch_size=256, collect_fragments=True, mesh_devices=2))
    scoring = CandidateScoring(td, tprec, tfrag, cfg, devices=TWO)
    assert scoring._mesh() is not None and len(scoring._mesh()) == 2
    psm_one, frag_one = CandidateScoring(td, tprec, tfrag, cfg, device="cpu")(cands)
    psm_two, frag_two = scoring(cands)
    assert len(psm_one["precursor_idx"]) > 100
    assert_exactly_equal(psm_two, psm_one)
    assert_exactly_equal(frag_two, frag_one)


def test_sharded_drivers_match_jax_mesh_drivers(world):
    jd, prec, frag, td, tprec, tfrag = world
    scfg = SelectionConfig(rt_tolerance=60.0, candidate_count=3, batch_size=1024, mesh_devices=2)
    assert JaxSelection(jd, prec, frag, scfg)._mesh().devices.size == 2
    theirs = JaxSelection(jd, prec, frag, scfg)()
    ours = CandidateSelection(td, tprec, tfrag, config_from_jax(scfg), devices=TWO)()
    assert sorted(ours) == sorted(theirs.columns) and len(ours["precursor_idx"]) == len(theirs) > 0
    for c in theirs.columns:
        a, b = ours[c], theirs[c].to_numpy()
        assert a.dtype == b.dtype, c
        if c == "score":
            np.testing.assert_allclose(a, b, rtol=F16_STEP, atol=1e-3)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)

    cfg = ScoringConfig(batch_size=512, collect_fragments=True, mesh_devices=2)
    psm, _ = JaxScoring(jd, prec, frag, cfg)(theirs)
    mine, _ = CandidateScoring(td, tprec, tfrag, config_from_jax(cfg), devices=TWO)(frame_from_pandas(theirs))
    assert len(mine["precursor_idx"]) == len(psm) > 100
    bf16 = {FEATURE_COLUMNS[i] for i in _BF16_FEATURES}
    for c in psm.columns:
        b, a = psm[c].to_numpy(), mine[c]
        if c in MASS_ERRORS:
            np.testing.assert_allclose(a, b, rtol=0, atol=0.06, err_msg=c)
        elif c in MOBILITY and td.has_mobility:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=c)
        elif c in FEATURE_COLUMNS:
            scale = np.maximum(np.abs(b.astype(np.float64)), 1.0)
            tol = BF16_STEP if c in bf16 else 2e-3
            assert (np.abs(a - b) <= tol * scale).all(), c
        elif b.dtype == object:
            assert [str(x) for x in a] == [str(x) for x in b], c
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)


def test_pipelined_over_two_devices_is_the_sequential_drivers(world):
    _, _, _, td, tprec, tfrag = world
    scfg = config_from_jax(SelectionConfig(batch_size=512, mesh_devices=2))
    ccfg = config_from_jax(ScoringConfig(batch_size=256, mesh_devices=2))
    cand, psm, frags = PipelinedExtraction(td, tprec, tfrag, scfg, ccfg, devices=TWO)()
    want_cand = CandidateSelection(td, tprec, tfrag, scfg, device="cpu")()
    want_psm, want_frag = CandidateScoring(td, tprec, tfrag, ccfg, device="cpu")(want_cand)
    assert_exactly_equal(cand, want_cand)
    assert_exactly_equal(psm, want_psm)
    assert_exactly_equal(frags, want_frag)


def test_config_from_jax_carries_mesh_devices():
    assert config_from_jax(SelectionConfig(mesh_devices=4)).mesh_devices == 4
    assert config_from_jax(ScoringConfig(mesh_devices=2)).mesh_devices == 2
    assert config_from_jax(ScoringConfig()).mesh_devices is None
