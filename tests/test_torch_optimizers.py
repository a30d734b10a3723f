"""The control logic of the optimization loop, the port against the JAX
package on the JAX package's own frames (a replay).

The JAX ``PeptideCentricWorkflow`` runs on a small world with every
extraction and every FDR fit recorded: the optimization manager's state and
the lock's batch at each extraction, the frames the extraction returned,
the PSMs the FDR fit returned and the classifier version after it. The
port's loop then runs on the same raw file and library with its extraction
and FDR fit replaced by those recordings, so every discrete decision of the
port's loop (batches, calibration, proposals, convergence, optimum rows)
is taken on JAX's inputs. Held at rtol 1e-9: the state at every extraction
(tolerances, candidate count, score cutoff, FWHM, quadrupole model,
classifier version), the optimizers' histories and step counts, the
calibrated columns of each batch and the final calibration; exactly: the
elution-group order, the batch plan, each batch's precursors and the
columns the drivers read. Worlds: 3D with every optimizer automatic, 4D
with ms1 and ms2 targeted and RT and mobility automatic.

Also against JAX: ``_filter_dfs`` on fragments with ties in correlation
and precursor_idx (and NaN correlations); the recalibration with an all-NaN
``mobility_fwhm`` and NaN ``cycle_fwhm`` values; the lock's order and
batches on a library whose elution groups appear unsorted.
"""

import numpy as np
import pandas as pd
import pytest

from alphadia_torch.config import load_default_config
from alphadia_torch.convert import frame_from_pandas
from alphadia_torch.library.speclib import SpecLibFlat
from alphadia_torch.utils.frame import Frame, n_rows
from alphadia_torch.workflow.managers.calibration_manager import CalibrationManager
from alphadia_torch.workflow.managers.optimization_manager import OptimizationManager
from alphadia_torch.workflow.optimizers.optimization_lock import OptimizationLock
from alphadia_torch.workflow.peptidecentric import extraction_handler as port_extraction
from alphadia_torch.workflow.peptidecentric.optimization_handler import OptimizationHandler
from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow
from alphadia_torch.workflow.peptidecentric.recalibration_handler import RecalibrationHandler
from alphadia_tpu.config import load_default_config as jax_load_default_config
from alphadia_tpu.library.speclib import SpecLibFlat as JaxSpecLibFlat
from alphadia_tpu.rawdata.source import save_npz
from alphadia_tpu.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
from alphadia_tpu.workflow.managers.calibration_manager import CalibrationManager as JaxCalibrationManager
from alphadia_tpu.workflow.managers.fdr_manager import FDRManager as JaxFDRManager
from alphadia_tpu.workflow.managers.optimization_manager import OptimizationManager as JaxOptimizationManager
from alphadia_tpu.workflow.optimizers.optimization_lock import OptimizationLock as JaxOptimizationLock
from alphadia_tpu.workflow.peptidecentric import extraction_handler as jax_extraction
from alphadia_tpu.workflow.peptidecentric.optimization_handler import OptimizationHandler as JaxOptimizationHandler
from alphadia_tpu.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow as JaxWorkflow
from alphadia_tpu.workflow.peptidecentric.recalibration_handler import RecalibrationHandler as JaxRecalibrationHandler
from torch_workflow_worlds import record_optimizers

pytest_plugins = ("torch_port_plugin",)

RTOL = 1e-9
STATE = (
    "ms1_error", "ms2_error", "rt_error", "mobility_error", "num_candidates", "fwhm_rt", "fwhm_mobility",
    "score_cutoff", "classifier_version", "quad_sigma", "quad_delta_mu",
)
CALIBRATED = {"precursor": ("mz_calibrated", "rt_calibrated", "mobility_calibrated"), "fragment": ("mz_calibrated",)}

WORLDS = {
    "3d_automatic": dict(
        world=dict(n_peptides=400, n_windows=6, n_cycles=400, seed=11, lib_ppm_bias=5.0, lib_rt_sigma=10.0),
        config={
            "general": {"random_state": 42, "save_figures": False},
            "calibration": {"batch_size": 150, "optimization_lock_target": 100, "min_steps": 2, "max_steps": 6},
            "search": {"target_ms1_tolerance": 0, "target_ms2_tolerance": 0, "target_rt_tolerance": 0},
            "search_initial": {"ms1_tolerance": 25, "ms2_tolerance": 25, "rt_tolerance": 0.3},
            "tpu": {"selection_batch": 256, "scoring_batch": 256},
        },
    ),
    "4d_rt_mobility_automatic": dict(
        world=dict(
            n_peptides=300, n_windows=6, n_cycles=300, seed=23, lib_ppm_bias=5.0, lib_rt_sigma=10.0,
            with_mobility=True,
        ),
        config={
            "general": {"random_state": 7, "save_figures": False},
            "calibration": {"batch_size": 150, "optimization_lock_target": 80, "min_steps": 2, "max_steps": 5},
            "search": {
                "target_ms1_tolerance": 10, "target_ms2_tolerance": 12, "target_rt_tolerance": 0,
                "target_mobility_tolerance": 0,
            },
            "search_initial": {"ms1_tolerance": 25, "ms2_tolerance": 25, "rt_tolerance": 0.3},
            "tpu": {"selection_batch": 256, "scoring_batch": 256},
        },
    ),
}


def snapshot(handler, lib) -> dict:
    """What one extraction is given: the optimization state, the columns the
    drivers read, the batch's precursors and its calibrated columns."""
    om = handler._om
    rec = {k: np.asarray(getattr(om, k), np.float64) for k in STATE}
    rec["columns"] = (
        handler._cols.get_rt_column(), handler._cols.get_precursor_mz_column(), handler._cols.get_fragment_mz_column()
    )
    rec["precursor_idx"] = np.asarray(lib.precursor_df["precursor_idx"]).copy()
    for group, df in (("precursor", lib.precursor_df), ("fragment", lib.fragment_df)):
        for c in CALIBRATED[group]:
            if c in df:
                rec[f"{group}.{c}"] = np.asarray(df[c]).copy()
    return rec


class ReplayFDR:
    """The JAX fits' PSMs, one a call, with the classifier version each left."""

    def __init__(self, fits):
        self.fits = list(fits)
        self.current_version = -1
        self.n_features = []

    def fit_predict(self, features, **kw):
        self.n_features.append(n_rows(features))
        psm, version, _ = self.fits.pop(0)
        self.current_version = version
        return psm


@pytest.fixture(scope="module", params=sorted(WORLDS))
def replay(request, tmp_path_factory):
    spec = WORLDS[request.param]
    tmp = tmp_path_factory.mktemp(f"replay_{request.param}")
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(**spec["world"]))
    prec, frag = add_synthetic_decoys(prec, frag)
    raw_path = str(tmp / "run.npz")
    save_npz(raw_path, spectra)

    # the JAX workflow, every extraction and FDR fit recorded
    extractions, fits = [], []
    jax_select_and_score = jax_extraction.ExtractionHandler.select_and_score
    jax_fit_predict = JaxFDRManager.fit_predict

    def recording_select_and_score(self, dia_data, lib, **kw):
        rec = snapshot(self, lib)
        out = jax_select_and_score(self, dia_data, lib, **kw)
        extractions.append((rec, tuple(frame_from_pandas(df) for df in out)))
        return out

    def recording_fit_predict(self, features, **kw):
        out = jax_fit_predict(self, features, **kw)
        fits.append((Frame(frame_from_pandas(out)), self.current_version, len(features)))
        return out

    cfg = jax_load_default_config()
    cfg.update_layer({**spec["config"], "output_directory": str(tmp / "jax")}, name="test")
    wf_j = JaxWorkflow("run", cfg)
    wf_j.load(raw_path, JaxSpecLibFlat(prec.copy(), frag.copy()))
    record_optimizers(wf_j)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_extraction.ExtractionHandler, "select_and_score", recording_select_and_score)
        mp.setattr(JaxFDRManager, "fit_predict", recording_fit_predict)
        wf_j.search_parameter_optimization()

    # the port's loop on the recordings
    replayed = []
    queue = list(extractions)

    def replaying_select_and_score(self, dia_data, lib):
        replayed.append(snapshot(self, lib))
        _, out = queue.pop(0)
        return out

    cfg = load_default_config()
    cfg.update_layer({**spec["config"], "output_directory": str(tmp / "port")}, name="test")
    wf_p = PeptideCentricWorkflow("run", cfg, device="cpu")
    wf_p.load(raw_path, SpecLibFlat(frame_from_pandas(prec), frame_from_pandas(frag)))
    record_optimizers(wf_p)
    fdr = ReplayFDR(fits)
    wf_p.optimization_handler._fdr_manager = fdr
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_extraction.ExtractionHandler, "select_and_score", replaying_select_and_score)
        wf_p.search_parameter_optimization()
    return dict(wf_j=wf_j, wf_p=wf_p, jax=[r for r, _ in extractions], port=replayed, fits=fits, fdr=fdr)


def assert_close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=RTOL, atol=0, err_msg=what)


def test_elution_group_order_and_batch_plan_are_exact(replay):
    lock_j = replay["wf_j"].optimization_handler._optlock
    lock_p = replay["wf_p"].optimization_handler._optlock
    np.testing.assert_array_equal(lock_p._elution_group_order, lock_j._elution_group_order)
    assert lock_p.batch_plan == lock_j.batch_plan
    assert lock_p.batch_idx == lock_j.batch_idx


def test_every_extraction_gets_jax_state_and_batch(replay):
    jax, port = replay["jax"], replay["port"]
    assert len(jax) > 3
    assert len(port) == len(jax)
    for i, (a, b) in enumerate(zip(port, jax)):
        assert a["columns"] == b["columns"], i
        np.testing.assert_array_equal(a["precursor_idx"], b["precursor_idx"], err_msg=f"extraction {i}")
        assert sorted(k for k in a if "." in k) == sorted(k for k in b if "." in k), i
        for k in b:
            if k not in ("columns", "precursor_idx"):
                assert_close(a[k], b[k], f"extraction {i}: {k}")
    # the lock accumulated the same features for every FDR fit
    assert replay["fdr"].n_features == [n for _, _, n in replay["fits"]]
    assert not replay["fdr"].fits


def test_optimizer_histories_and_convergence_match(replay):
    groups_j, groups_p = replay["wf_j"].ordered_optimizers, replay["wf_p"].ordered_optimizers
    assert [[o.parameter_name for o in g] for g in groups_p] == [[o.parameter_name for o in g] for g in groups_j]
    automatic = 0
    for oj, op in zip((o for g in groups_j for o in g), (o for g in groups_p for o in g)):
        assert type(op).__name__ == type(oj).__name__
        assert op.has_converged == oj.has_converged
        assert op._num_prev_optimizations == oj._num_prev_optimizations
        if hasattr(oj, "history_df"):
            automatic += 1
            h = oj.history_df
            assert n_rows(op.history_df) == len(h) > 0
            for col in h.columns:
                assert_close(op.history_df[col], h[col].to_numpy(np.float64), f"{op.parameter_name} history {col}")
            if oj.has_converged:
                assert op._find_index_of_optimum() == oj._find_index_of_optimum()
    assert automatic >= 2
    om_j, om_p = replay["wf_j"].optimization_manager, replay["wf_p"].optimization_manager
    for k in STATE:
        assert_close(getattr(om_p, k), getattr(om_j, k), f"final {k}")
    assert replay["wf_p"].optimization_handler._optlock.batch_idx == replay["wf_j"].optimization_handler._optlock.batch_idx


def test_final_calibration_matches(replay):
    cm_j, cm_p = replay["wf_j"].calibration_manager, replay["wf_p"].calibration_manager
    for group, ests in cm_j.groups.items():
        assert sorted(cm_p.groups[group]) == sorted(ests)
        for name, ej in ests.items():
            ep = cm_p.groups[group][name]
            assert ep.is_fitted == ej.is_fitted
            if ej.is_fitted:
                for attr in ("centers", "halfwidths", "beta"):
                    np.testing.assert_allclose(getattr(ep.function, attr), getattr(ej.function, attr), rtol=1e-10)
                for k, v in ej.metrics.items():
                    assert_close(ep.metrics[k], v, f"{group}.{name} {k}")
    lib_j, lib_p = replay["wf_j"].spectral_library, replay["wf_p"].spectral_library
    for group, (dj, dp) in (("precursor", (lib_j.precursor_df, lib_p.precursor_df)), ("fragment", (lib_j.fragment_df, lib_p.fragment_df))):
        for c in CALIBRATED[group]:
            assert (c in dp) == (c in dj.columns), c
            if c in dp:
                np.testing.assert_array_equal(dp[c], dj[c].to_numpy())


# ---------------------------------------------------------------------------
def _fragments_with_ties(seed=3, n=1400):
    rng = np.random.default_rng(seed)
    corr = rng.choice([0.95, 0.9, 0.75, 0.6, 0.3, np.nan], size=n).astype(np.float32)
    return pd.DataFrame(
        {
            "precursor_idx": rng.integers(0, 40, n).astype(np.uint32),
            "rank": np.zeros(n, np.uint8),
            "mass_error": rng.normal(0, 150, n).astype(np.float32),
            "correlation": corr,
            "mz_library": rng.uniform(200, 1400, n).astype(np.float32),
            "tag": np.arange(n),
        }
    )


@pytest.mark.parametrize("min_correlation,max_fragments", [(0.7, 5000), (0.7, 300), (0.99, 5000)])
def test_filter_dfs_sorts_ties_as_pandas(min_correlation, max_fragments):
    frag = _fragments_with_ties()
    rng = np.random.default_rng(5)
    prec = pd.DataFrame(
        {
            "precursor_idx": np.arange(40, dtype=np.uint32),
            "qval": rng.choice([0.0, 0.005, 0.02], 40),
            "decoy": rng.choice([0, 0, 1], 40).astype(np.uint8),
        }
    )
    config = {"calibration": {"min_correlation": min_correlation, "max_fragments": max_fragments}}
    jax = JaxOptimizationHandler.__new__(JaxOptimizationHandler)
    jax._config = config
    port = OptimizationHandler.__new__(OptimizationHandler)
    port._config = config
    pj, fj = jax._filter_dfs(prec, frag)
    pp, fp = port._filter_dfs(frame_from_pandas(prec), frame_from_pandas(frag))
    np.testing.assert_array_equal(pp["precursor_idx"], pj["precursor_idx"].to_numpy())
    assert len(fj) > 0
    np.testing.assert_array_equal(fp["tag"], fj["tag"].to_numpy())


def _psms(has_mobility_values: bool, seed=9, n=300):
    rng = np.random.default_rng(seed)
    mz = rng.uniform(400, 1000, n)
    rt = rng.uniform(0, 600, n)
    cycle_fwhm = rng.uniform(2, 8, n)
    cycle_fwhm[::7] = np.nan
    return pd.DataFrame(
        {
            "precursor_idx": np.arange(n, dtype=np.uint32),
            "mz_library": mz.astype(np.float32),
            "mz_observed": (mz * (1 + (4 + rng.normal(0, 1, n)) * 1e-6)).astype(np.float32),
            "rt_library": rt.astype(np.float32),
            "rt_observed": (rt + 5 + rng.normal(0, 3, n)).astype(np.float32),
            "score": rng.normal(10, 3, n).astype(np.float32),
            "cycle_fwhm": cycle_fwhm.astype(np.float32),
            "mobility_fwhm": rng.uniform(0.01, 0.03, n).astype(np.float32) if has_mobility_values else np.full(n, np.nan, np.float32),
        }
    )


@pytest.mark.parametrize("has_mobility_values", [False, True], ids=["all_nan_mobility_fwhm", "mobility_fwhm"])
def test_recalibration_skips_nan_as_pandas(has_mobility_values):
    psm = _psms(has_mobility_values)
    frag = _fragments_with_ties()
    frag["mz_observed"] = (frag["mz_library"] * (1 + 4e-6)).astype(np.float32)
    cfg_j, cfg_p = jax_load_default_config(), load_default_config()
    om_j, om_p = JaxOptimizationManager(cfg_j, 600.0), OptimizationManager(cfg_p, 600.0)
    cm_j, cm_p = JaxCalibrationManager(has_ms1=True), CalibrationManager(has_ms1=True)
    JaxRecalibrationHandler(cfg_j, om_j, cm_j).recalibrate(psm, frag)
    RecalibrationHandler(cfg_p, om_p, cm_p).recalibrate(frame_from_pandas(psm), frame_from_pandas(frag))
    for k in ("fwhm_rt", "fwhm_mobility", "score_cutoff", "num_candidates"):
        a, b = getattr(om_p, k), getattr(om_j, k)
        assert (np.isnan(a) and np.isnan(b)) if np.isnan(b) else np.isclose(a, b, rtol=RTOL, atol=0), (k, a, b)
    assert np.isnan(om_p.fwhm_mobility) == (not has_mobility_values)
    x = np.linspace(380, 1020, 50)
    for group in ("precursor", "fragment"):
        for name, ej in cm_j.groups[group].items():
            np.testing.assert_allclose(cm_p.groups[group][name].function.predict(x), ej.function.predict(x), rtol=1e-10)


def test_lock_order_and_batches_on_unsorted_groups():
    """Elution groups that appear unsorted and repeated: the shuffled order
    follows first appearance (pandas ``unique``), and every batch of the
    lock's plan holds the same precursors."""
    rng = np.random.default_rng(2)
    n = 900
    groups = rng.permutation(np.repeat(rng.permutation(400)[:300], 3))
    counts = rng.integers(1, 5, n)
    stops = np.cumsum(counts)
    prec = pd.DataFrame(
        {
            "precursor_idx": np.arange(n, dtype=np.uint32),
            "elution_group_idx": groups.astype(np.uint32),
            "flat_frag_start_idx": (stops - counts).astype(np.uint32),
            "flat_frag_stop_idx": stops.astype(np.uint32),
        }
    )
    frag = pd.DataFrame({"mz_library": rng.uniform(200, 1400, int(stops[-1])).astype(np.float32)})
    config = {"calibration": {"optimization_lock_target": 50, "batch_size": 20}}
    lj = JaxOptimizationLock(JaxSpecLibFlat(prec, frag), config)
    lp = OptimizationLock(SpecLibFlat(frame_from_pandas(prec), frame_from_pandas(frag)), config)
    np.testing.assert_array_equal(lp._elution_group_order, lj._elution_group_order)
    assert lp.batch_plan == lj.batch_plan and len(lj.batch_plan) > 3
    while True:
        for k in ("precursor_idx", "flat_frag_start_idx", "flat_frag_stop_idx"):
            np.testing.assert_array_equal(lp.batch_library.precursor_df[k], lj.batch_library.precursor_df[k].to_numpy())
        np.testing.assert_array_equal(lp.batch_library.fragment_df["mz_library"], lj.batch_library.fragment_df["mz_library"].to_numpy())
        if not lj.batches_remaining():
            break
        lj.update()
        lp.update()
