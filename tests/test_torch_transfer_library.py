"""``transfer_library.enabled`` through ``SearchStep``, and the transfer
library (``outputs/transfer_library.py``), against the JAX package on the
CPU.

- Both packages' ``SearchStep`` with ``transfer_library.enabled`` on two
  runs of a small physics world (``testing/physics.py``'s RT and MS2, every
  fragment planted) and its base library: each run's
  ``frag.transfer.parquet`` holds more fragments a precursor than
  ``frag.parquet``, ``speclib.transfer.parquet`` and
  ``speclib.transfer.fragments.parquet`` are written;
- ``accumulate_transfer_library`` of both packages on each package's run
  folders: the same rows, integer and text columns exactly, floats within
  1e-6; ``build_run_speclib`` too;
- on a physics world where no window overflows its slab, both packages'
  step give the same transfer library (Jaccard >= 0.97, sizes within 2%)
  and the models tuned on it the same metrics (rtol 1e-3, atol 5e-4);
- the step's data decision: a requant that quantifies fewer fragments than
  the scored set keeps the scored set with a warning; an error in the
  requant is the run's error (no fallback); with
  ``transfer_learning.enabled`` the models are fine-tuned on the step's
  transfer library, with JAX's stats columns and model keys.
"""

import logging

import numpy as np
import pandas as pd
import pytest

pytest_plugins = ("torch_port_plugin",)

SMALL_PHYSICS_WORLD = dict(n_windows=4, n_cycles=200, noise_peaks_per_spectrum=20, seed=5, detectable_fraction=0.9)
STEP_CONFIG = {
    "general": {"random_state": 3, "save_figures": False},
    "calibration": {"batch_size": 150, "optimization_lock_target": 30, "min_steps": 2, "max_steps": 4},
    "search": {"target_ms1_tolerance": 10, "target_ms2_tolerance": 12, "target_rt_tolerance": 60},
    "search_initial": {"ms1_tolerance": 25, "ms2_tolerance": 25, "rt_tolerance": 0.5},
    "tpu": {"selection_batch": 256, "scoring_batch": 256},
    "transfer_library": {"enabled": True},
}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Both packages' search step with the transfer library on the same
    files: {"jax": out, "port": out}, and the inputs."""
    import alphadia_torch.search_step as port_step
    import alphadia_tpu.search_step as jax_step
    from torch_workflow_worlds import REQUANT_FASTA, write_transfer_inputs

    tmp = tmp_path_factory.mktemp("transfer_step")
    fasta = tmp / "physics.fasta"
    fasta.write_text(REQUANT_FASTA)
    lib, raws, _, _, _ = write_transfer_inputs(tmp, world=SMALL_PHYSICS_WORLD, fasta=fasta, missed_cleavages=1)
    cfg = {**STEP_CONFIG, "library_path": str(lib), "raw_paths": [str(r) for r in raws]}
    out = {}
    for who, make in (("jax", lambda o: jax_step.SearchStep(str(o), config=cfg)),
                      ("port", lambda o: port_step.SearchStep(str(o), config=cfg, device="cpu"))):
        step = make(tmp / who)
        step.run()
        assert not step.errors, (who, step.errors)
        out[who] = tmp / who
    return out, raws


@pytest.mark.parametrize("who", ["port", "jax"])
def test_the_step_writes_the_transfer_files(steps, who):
    from alphadia_torch.utils.parquet import read_parquet

    out, raws = steps
    for raw in raws:
        run = out[who] / "quant" / raw.stem
        scored, transfer = read_parquet(run / "frag.parquet"), read_parquet(run / "frag.transfer.parquet")
        _, per_scored = np.unique(scored["precursor_idx"], return_counts=True)
        _, per_transfer = np.unique(transfer["precursor_idx"], return_counts=True)
        assert len(transfer["precursor_idx"]) > len(scored["precursor_idx"])
        assert np.median(per_transfer) > 1.5 * np.median(per_scored)
        assert "_candidate_idx" in transfer
    psm = read_parquet(out[who] / "speclib.transfer.parquet")
    frag = read_parquet(out[who] / "speclib.transfer.fragments.parquet")
    assert len(psm["precursor_idx"]) > 20 and len(frag["precursor_idx"]) > 10 * len(psm["precursor_idx"])
    assert (psm["corr_median"] > 0.5).all() and ((psm["rt_norm"] >= 0) & (psm["rt_norm"] <= 1)).all()


def _assert_close_frames(theirs: pd.DataFrame, ours: dict, where: str):
    assert list(theirs.columns) == list(ours), (where, list(theirs.columns), list(ours))
    for c in theirs.columns:
        a, b = theirs[c].to_numpy(), np.asarray(ours[c])
        if a.dtype == object:
            assert [str(x) for x in a] == [str(x) for x in b], (where, c)
        elif a.dtype.kind == "f":
            assert b.dtype == a.dtype, (where, c, a.dtype, b.dtype)
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=f"{where} {c}")
            assert np.array_equal(np.isnan(a), np.isnan(b)), (where, c)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), (where, c, a.dtype, b.dtype)


@pytest.mark.parametrize("folders_of", ["jax", "port"])
@pytest.mark.parametrize("norm_delta_max", [True, False])
def test_accumulate_transfer_library_matches_jax(steps, folders_of, norm_delta_max):
    from alphadia_torch.outputs.transfer_library import accumulate_transfer_library
    from alphadia_tpu.outputs.transfer_library import accumulate_transfer_library as jax_accumulate

    out, raws = steps
    folders = [out[folders_of] / "quant" / r.stem for r in raws]
    kw = dict(top_k_samples=1, norm_delta_max=norm_delta_max)
    theirs = jax_accumulate(folders, **kw)
    ours = accumulate_transfer_library(folders, **kw)
    assert len(theirs[0]) > 20
    _assert_close_frames(theirs[0], ours[0], "precursors")
    _assert_close_frames(theirs[1], ours[1], "fragments")


def test_build_run_speclib_and_an_empty_folder_list_match_jax(steps, tmp_path):
    from alphadia_torch.outputs.transfer_library import accumulate_transfer_library, build_run_speclib
    from alphadia_torch.utils.parquet import read_parquet
    from alphadia_tpu.outputs.transfer_library import build_run_speclib as jax_build

    out, raws = steps
    run = out["jax"] / "quant" / raws[0].stem
    psm, frag = pd.read_parquet(run / "psm.parquet"), pd.read_parquet(run / "frag.transfer.parquet")
    theirs = jax_build(psm, frag, "run_0")
    ours = build_run_speclib(read_parquet(run / "psm.parquet"), read_parquet(run / "frag.transfer.parquet"), "run_0")
    _assert_close_frames(theirs[0].reset_index(drop=True), ours[0], "psm")
    _assert_close_frames(theirs[1].reset_index(drop=True), ours[1], "frag")
    assert accumulate_transfer_library([tmp_path / "nothing"]) == ({}, {})


# a physics world whose densest cell holds 205 peaks over the whole run (8
# isolation windows spread the y1 ions of K and R that pile into one coarse
# bin with fewer): no window of any launch, search or transfer requant (which
# reads at ScoringConfig's default slab of 256 in both packages, whatever
# tpu.gather_slab says), can overflow its slab
NO_OVERFLOW_WORLD = dict(n_windows=8, n_cycles=200, noise_peaks_per_spectrum=10, seed=5, detectable_fraction=0.9)


def test_the_packages_agree_where_no_window_overflows(tmp_path):
    """Where no window overflows its slab, the port's transfer library is
    JAX's: both packages' step with the transfer library on a small physics
    world give the same transfer PSMs (sequence and charge; equal at random
    states 0 and 3 when this was written), and the models tuned on it the
    same metrics. On the 20-protein physics world,
    whose windows overflow, the port reads 3-4% above JAX at the default
    slab (ROADMAP §3)."""
    import alphadia_torch.search_step as port_step
    import alphadia_tpu.search_step as jax_step
    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.rawdata.mzml import read_mzml
    from alphadia_torch.utils.parquet import read_parquet
    from alphadia_torch.utils.tsv import read_tsv
    from torch_workflow_worlds import REQUANT_FASTA, transfer_readings, write_transfer_inputs

    fasta = tmp_path / "physics.fasta"
    fasta.write_text(REQUANT_FASTA)
    lib, raws, _, _, _ = write_transfer_inputs(tmp_path, world=NO_OVERFLOW_WORLD, fasta=fasta, missed_cleavages=1)
    for raw in raws:
        cs = DiaData.from_spectra(read_mzml(raw)).cell_start.astype(np.int64)
        assert (cs[..., -1] - cs[..., 0]).max() <= 256  # no window of any length overflows
    cfg = {**STEP_CONFIG, "library_path": str(lib), "raw_paths": [str(r) for r in raws],
           "transfer_learning": {"enabled": True, "epochs": 5, "batch_size": 64}}
    got = {}
    for who, make in (("jax", lambda o: jax_step.SearchStep(str(o), config=cfg)),
                      ("port", lambda o: port_step.SearchStep(str(o), config=cfg, device="cpu"))):
        step = make(tmp_path / who)
        step.run()
        assert not step.errors, (who, step.errors)
        psm = read_parquet(tmp_path / who / "speclib.transfer.parquet")
        got[who] = (transfer_readings(tmp_path / who), set(zip(psm["sequence"].tolist(), psm["charge"].tolist())),
                    read_tsv(tmp_path / who / "stats.transfer.tsv"))
    (want, a, want_stats), (ours, b, our_stats) = got["jax"], got["port"]
    assert want["transfer_psms"] > 100
    assert len(a & b) / len(a | b) >= 0.97
    for k in ("transfer_psms", "transfer_precursors", "transfer_fragments"):
        assert abs(ours[k] - want[k]) <= 0.02 * want[k], k
    # the models tuned on it: JAX's metrics at the fits' tolerance (tests/test_torch_finetune.py: rtol
    # 1e-3), with atol 5e-4 for values near 0 (five epochs leave the RT R² at 0.17; 2.2e-4 apart)
    assert list(our_stats) == list(want_stats)
    for k in want_stats:
        np.testing.assert_allclose(our_stats[k], want_stats[k], rtol=1e-3, atol=5e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the step's decisions
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_inputs(tmp_path_factory):
    from torch_workflow_worlds import WORLDS, write_search_inputs

    return write_search_inputs(tmp_path_factory.mktemp("inputs"), WORLDS["3d"]["world"])


def _port_step(tmp, inputs, **extra):
    from alphadia_torch.search_step import SearchStep

    cfg = {"library_path": str(inputs[1]), "raw_paths": [str(inputs[0])], "transfer_library": {"enabled": True},
           "general": {"random_state": 0}, **extra}
    return SearchStep(str(tmp / "out"), config=cfg, device="cpu")


@pytest.fixture(scope="module")
def extracted(small_inputs, tmp_path_factory):
    """The port's extraction of the small world, run once: (PSMs, fragments)."""
    from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow

    kept, extraction = {}, PeptideCentricWorkflow.extraction

    def keep(self):
        kept["out"] = extraction(self)
        return kept["out"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PeptideCentricWorkflow, "extraction", keep)
        _port_step(tmp_path_factory.mktemp("once"), small_inputs, transfer_library={"enabled": False}).run()
    return kept["out"]


def _replayed(monkeypatch, extracted, requantify_fragments):
    """The step's workflow replaying ``extracted`` (no search), with
    ``requantify_fragments`` in place of the requant."""
    from alphadia_torch.utils.frame import copy_frame
    from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow

    class NoDevice:
        def free_device(self):
            pass

    def load(self, raw_path, library):
        self.dia_data = NoDevice()

    monkeypatch.setattr(PeptideCentricWorkflow, "load", load)
    monkeypatch.setattr(PeptideCentricWorkflow, "search_parameter_optimization", lambda self: None)
    monkeypatch.setattr(PeptideCentricWorkflow, "extraction", lambda self: tuple(copy_frame(f) for f in extracted))
    monkeypatch.setattr(PeptideCentricWorkflow, "requantify_fragments", requantify_fragments)


def test_a_requant_of_fewer_fragments_keeps_the_scored_set(tmp_path, small_inputs, extracted, monkeypatch, caplog):
    from alphadia_torch.utils.frame import take
    from alphadia_torch.utils.parquet import read_parquet

    def fewer(self, psm):
        frag = extracted[1]
        return psm, take(frag, np.arange(len(frag["precursor_idx"])) < 3)

    _replayed(monkeypatch, extracted, fewer)
    step = _port_step(tmp_path, small_inputs)
    with caplog.at_level(logging.WARNING, logger="alphadia_torch"):
        step.run()
    run = tmp_path / "out" / "quant" / small_inputs[0].stem
    scored, transfer = read_parquet(run / "frag.parquet"), read_parquet(run / "frag.transfer.parquet")
    assert list(scored) == list(transfer)
    assert all(np.array_equal(scored[c], transfer[c]) for c in scored)
    assert any("keeping the scored set" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("fail_fast", [False, True])
def test_an_error_in_the_requant_is_the_runs_error(tmp_path, small_inputs, extracted, monkeypatch, fail_fast):
    """No fallback to the scored set: the error goes to the step's per-file
    handling, as one in ``extraction()`` does, and the run writes none of
    its files."""
    from alphadia_torch.exceptions import NoPsmFoundError

    def broken(self, psm):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    _replayed(monkeypatch, extracted, broken)
    step = _port_step(tmp_path, small_inputs, general={"random_state": 0, "fail_fast": fail_fast})
    with pytest.raises(RuntimeError if fail_fast else NoPsmFoundError):
        step.run()
    assert step.errors and "illegal memory access" in step.errors[0][1]
    assert not list((tmp_path / "out" / "quant" / small_inputs[0].stem).glob("*.parquet"))


def test_transfer_learning_fine_tunes_on_the_steps_transfer_library(tmp_path, steps):
    """With ``transfer_learning.enabled`` the outputs fine-tune the models
    on the transfer library of the port's step: both packages'
    ``_build_transfer_library`` + ``_build_transfer_model`` on the port's run
    folders write the same stats columns and model keys (no mobility, so no
    ``ccs``), and the saved models predict."""
    from alphadia_torch.models.finetune import FinetuneManager
    from alphadia_torch.outputs.search_plan_output import SearchPlanOutput
    from alphadia_torch.utils.tsv import read_tsv
    from alphadia_tpu.outputs.search_plan_output import SearchPlanOutput as JaxSearchPlanOutput

    out, raws = steps
    folders = [out["port"] / "quant" / r.stem for r in raws]
    config = {
        "transfer_library": {"enabled": True, "top_k_samples": 3, "precursor_correlation_cutoff": 0.5,
                             "fragment_correlation_ratio": 0.75, "norm_delta_max": True},
        "transfer_learning": {"enabled": True, "epochs": 3, "batch_size": 64},
    }
    stats = {}
    for who, make in (("jax", lambda o: JaxSearchPlanOutput(config, o)),
                      ("port", lambda o: SearchPlanOutput(config, o, device="cpu"))):
        (tmp_path / who).mkdir()
        spo = make(tmp_path / who)
        spo._build_transfer_model(*spo._build_transfer_library(folders))
        stats[who] = read_tsv(tmp_path / who / "stats.transfer.tsv")
    assert list(stats["port"]) == list(stats["jax"])
    assert {"rt_r2", "rt_abs_error_95", "charge_accuracy", "ms2_spectral_angle"} <= set(stats["port"])
    models = FinetuneManager.load(tmp_path / "port" / "peptdeep.transfer", device="cpu")
    assert sorted(models.variables) == ["charge", "ms2", "rt"]
    assert np.isfinite(models.predict_rt(["PEPTIDEK", "LVNEVTEFAK"])).all()
