"""The per-run workflow end to end on the CPU, the JAX package's
``PeptideCentricWorkflow`` against the port's: a ``.npz`` raw file and a
flat library -> ``load`` -> ``search_parameter_optimization`` ->
``extraction``, on the 3D world of ``tests/integration/test_workflow.py``
and the 4D world of ``tests/integration/test_workflow_4d.py``, with their
configs.

Held: the same number of steps per optimizer, the final tolerances within
5%, the target IDs at 1% FDR with a Jaccard overlap >= 0.95, and the JAX
test's own gates on the port (precision > 0.93, recall > 0.5, median RT
error < 3 s, fragments of surviving PSMs only, both managers pickled).

Run as a script it runs both workflows on a quarter of a ``chip_smoke.py``
phase-[7] world (3 isolation windows instead of 12, the same density a
window; the port's default config) and prints the JAX package's identified
and false shares at 1% FDR and its fragment m/z calibration's distance from
the planted library bias, which phase [7] gates against:

    PYTHONPATH=. python tests/test_torch_workflow.py --peptides 1500 --windows 3
    PYTHONPATH=. python tests/test_torch_workflow.py --peptides 6250 --windows 3 --mobility --batch-size 2000

``--random-state 0 1 2`` reads several states, ``--parting`` also prints,
per FDR call, where the two runs part (the candidates, the features, the
best candidate of each precursor).

(``--batch-size 2000``: the 4D steps then search the share of the library
that they search on the 4D world of ``chip_smoke.py``, 8,000 of 25,000
elution groups.)
"""

import argparse

import numpy as np
import pytest

from alphadia_torch.config import load_default_config
from alphadia_torch.convert import frame_from_pandas
from alphadia_torch.library.speclib import SpecLibFlat
from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow
from alphadia_tpu.config import load_default_config as jax_load_default_config
from alphadia_tpu.library.speclib import SpecLibFlat as JaxSpecLibFlat
from alphadia_tpu.rawdata.source import save_npz
from alphadia_tpu.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
from alphadia_tpu.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow as JaxWorkflow
from torch_workflow_worlds import TOLERANCES, WORLDS, run_workflow, steps_per_optimizer, target_ids

pytest_plugins = ("torch_port_plugin",)

TOL_REL = 0.05
JACCARD_MIN = 0.95


def make_world(tmp, world: dict, name: str = "synthetic"):
    """(raw path, precursors, fragments) of a seeded world of the JAX
    package's generator with decoys, the raw file written as ``.npz``, the
    library as pandas frames."""
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(**world))
    prec, frag = add_synthetic_decoys(prec, frag)
    raw_path = tmp / f"{name}.npz"
    save_npz(raw_path, spectra)
    return str(raw_path), prec, frag


def run_both(tmp, world: dict, config: dict, random_state=None):
    """The JAX package's workflow and the port's on one world and config
    layer: {"jax": (workflow, psm, fragments), "port": (...)}, the frames
    column dicts."""
    raw_path, prec, frag = make_world(tmp, world)
    jcfg = jax_load_default_config()
    jcfg.update_layer(config, name="test")
    jax_lib = JaxSpecLibFlat(prec.copy(), frag.copy())
    wf_j, psm_j, frag_j = run_workflow(
        lambda c: JaxWorkflow("synthetic", c, random_state=random_state), jcfg, raw_path, jax_lib, tmp / "jax"
    )
    pcfg = load_default_config()
    pcfg.update_layer(config, name="test")
    wf_p, psm_p, frag_p = run_workflow(
        lambda c: PeptideCentricWorkflow("synthetic", c, random_state=random_state, device="cpu"),
        pcfg, raw_path, SpecLibFlat(frame_from_pandas(prec), frame_from_pandas(frag)), tmp / "port",
    )
    runs = {"jax": (wf_j, frame_from_pandas(psm_j), frame_from_pandas(frag_j)), "port": (wf_p, psm_p, frag_p)}
    return runs, frame_from_pandas(prec)


@pytest.fixture(scope="module", params=sorted(WORLDS))
def both(request, tmp_path_factory):
    spec = WORLDS[request.param]
    runs, prec = run_both(tmp_path_factory.mktemp(f"wf_{request.param}"), spec["world"], spec["config"])
    return request.param, runs, prec


def test_steps_and_tolerances_match_jax(both):
    kind, runs, _ = both
    wf_j, wf_p = runs["jax"][0], runs["port"][0]
    assert steps_per_optimizer(wf_p) == steps_per_optimizer(wf_j)
    for name in TOLERANCES:
        a, b = getattr(wf_p.optimization_manager, name), getattr(wf_j.optimization_manager, name)
        assert abs(a - b) <= TOL_REL * abs(b), (kind, name, a, b)
    if kind == "4d":
        assert "mobility_error" in steps_per_optimizer(wf_p)


def test_ids_at_1pct_fdr_match_jax(both):
    _, runs, _ = both
    ours, theirs = target_ids(runs["port"][1]), target_ids(runs["jax"][1])
    assert len(theirs) > 100
    assert len(ours & theirs) / len(ours | theirs) >= JACCARD_MIN


def test_port_meets_the_jax_tests_gates(both):
    """The JAX integration tests' own gates, on the port's run."""
    _, runs, prec = both
    wf, psm, frag = runs["port"]
    assert len(psm["precursor_idx"]) > 0 and (psm["qval"] <= 0.01).all()
    targets = psm["decoy"] == 0
    assert targets.mean() >= 0.95
    row = {int(p): i for i, p in enumerate(prec["precursor_idx"])}
    rows = np.array([row[int(p)] for p in psm["precursor_idx"]], np.int64)
    hit = prec["_truth_detectable"][rows[targets]]
    assert hit.mean() > 0.93, f"precision {hit.mean()}"
    recall = hit.sum() / int(prec["_truth_detectable"][prec["decoy"] == 0].sum())
    assert recall > 0.5, f"recall {recall}"
    assert np.median(np.abs(psm["rt_observed"] - prec["_truth_rt"][rows])) < 3.0
    assert set(frag["precursor_idx"].tolist()) <= set(psm["precursor_idx"].tolist())
    assert wf.calibration_manager.get_estimator("fragment", "mz").is_fitted
    assert (wf.path / wf.CALIBRATION_MANAGER_PKL).exists()
    assert (wf.path / wf.OPTIMIZATION_MANAGER_PKL).exists()
    assert (wf.path / "events.jsonl").exists()


# ---------------------------------------------------------------------------
# the JAX readings of chip_smoke.py phase [7]
# ---------------------------------------------------------------------------
PHASE7_CONFIG = {"general": {"random_state": 0, "save_figures": False}}


def id_shares(cycle_rt, prec: dict, psm: dict) -> tuple[float, float, int, int]:
    """(identified share, realised false share, targets, decoys at 1% FDR):
    the share of detectable targets with a target PSM at q <= 0.01, and the
    share of those accepted targets whose PSM lies more than 3 cycles from
    the generator's true apex."""
    accepted = psm["qval"] <= 0.01
    target = psm["decoy"] == 0
    pidx = psm["precursor_idx"][accepted & target]
    det = prec["_truth_detectable"] & (prec["decoy"] == 0)
    identified = float(np.isin(prec["precursor_idx"][det], pidx).mean()) if det.any() else 0.0
    truth_cycle = np.abs(cycle_rt[None, :] - prec["_truth_rt"][:, None]).argmin(1)
    row = {int(p): i for i, p in enumerate(prec["precursor_idx"])}
    rows = np.array([row[int(p)] for p in pidx], np.int64)
    off = np.abs(psm["frame_center"][accepted & target] - truth_cycle[rows]) > 3
    return identified, float(off.mean()) if len(off) else 0.0, int(len(pidx)), int((accepted & ~target).sum())


def bias_error(wf, fragments: dict, planted_ppm: float) -> float:
    """|median ppm shift of the fitted fragment m/z calibration over the
    library's fragments - the planted library bias|."""
    est = wf.calibration_manager.get_estimator("fragment", "mz")
    mz = np.asarray(fragments["mz_library"], np.float64)
    mz = mz[mz > 0]
    return abs(float(np.median((est.function.predict(mz) - mz) / mz * 1e6)) - planted_ppm)


def record_fdr_steps(monkeypatch_like) -> dict:
    """Record each package's ``FDRManager.fit_predict`` inputs and outputs
    per call (one a step, then the final extraction): {"jax": [(features,
    output), ...], "port": [...]}, each frame a column dict."""
    import alphadia_torch.workflow.managers.fdr_manager as port_fdr
    import alphadia_tpu.workflow.managers.fdr_manager as jax_fdr

    rec = {"jax": [], "port": []}
    for who, module in (("jax", jax_fdr), ("port", port_fdr)):
        orig = module.FDRManager.fit_predict

        def fit_predict(self, features, *a, _orig=orig, _who=who, **k):
            out = _orig(self, features, *a, **k)
            as_dict = frame_from_pandas if _who == "jax" else dict
            rec[_who].append((as_dict(features), as_dict(out)))
            return out

        monkeypatch_like.setattr(module.FDRManager, "fit_predict", fit_predict)
    return rec


def print_first_parting(rec: dict) -> None:
    """Per FDR call while both packages have one: the candidates only one
    side scored, the feature columns that differ (relative to max(|x|, 1)
    above 1e-4) on the candidates both scored, and the precursors whose best
    candidate (the fit's output) differs, with their probabilities."""
    for step, ((fj, oj), (fp, op)) in enumerate(zip(rec["jax"], rec["port"])):
        kj = list(zip(fj["precursor_idx"].tolist(), fj["rank"].tolist()))
        ip = {k: i for i, k in enumerate(zip(fp["precursor_idx"].tolist(), fp["rank"].tolist()))}
        both_ = [i for i, k in enumerate(kj) if k in ip]
        a, b = np.array(both_, np.int64), np.array([ip[kj[i]] for i in both_], np.int64)
        differ = {}
        for c in fj:
            if c in fp and fj[c].dtype.kind in "fiu":
                x, y = fj[c][a].astype(np.float64), fp[c][b].astype(np.float64)
                n = int((np.abs(x - y) / np.maximum(np.abs(x), 1) > 1e-4).sum())
                if n:
                    differ[c] = n
        best_j = dict(zip(oj["precursor_idx"].tolist(), oj["rank"].tolist()))
        best_p = dict(zip(op["precursor_idx"].tolist(), op["rank"].tolist()))
        moved = [p for p in best_j if p in best_p and best_j[p] != best_p[p]]
        print(
            f"FDR call {step}: candidates {len(kj)} / {len(ip)}, scored by one side only {len(kj) + len(ip) - 2 * len(a)}; "
            f"features differing (rows): {dict(sorted(differ.items(), key=lambda t: -t[1])[:6])}; best candidate "
            f"differs for {len(moved)} precursors",
            flush=True,
        )
        for p in moved[:3]:
            i, k = list(oj["precursor_idx"]).index(p), list(op["precursor_idx"]).index(p)
            print(
                f"  precursor {p}: JAX rank {best_j[p]} (rt_observed {oj['rt_observed'][i]:.1f} s, proba "
                f"{oj['proba'][i]:.7f}), port rank {best_p[p]} (rt_observed {op['rt_observed'][k]:.1f} s, proba "
                f"{op['proba'][k]:.7f})",
                flush=True,
            )


def main():
    import tempfile
    from pathlib import Path

    ap = argparse.ArgumentParser(description="the workflow on a quarter world, JAX and the port: the phase-[7] readings")
    ap.add_argument("--peptides", type=int, default=1500)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--mobility", action="store_true")
    ap.add_argument(
        "--batch-size", type=int, default=None,
        help="calibration.batch_size (default: the config's); scale it with the world to keep the share of the "
        "library that the optimization steps search",
    )
    ap.add_argument("--random-state", type=int, nargs="+", default=[0])
    ap.add_argument("--parting", action="store_true", help="also print, per FDR call, where the two runs part")
    opt = ap.parse_args()
    world = dict(
        n_peptides=opt.peptides, n_windows=opt.windows, n_cycles=600, noise_peaks_per_spectrum=80, seed=5,
        with_mobility=opt.mobility,
    )
    config = dict(PHASE7_CONFIG)
    if opt.batch_size is not None:
        config["calibration"] = {"batch_size": opt.batch_size}
    planted = SyntheticConfig().lib_ppm_bias
    for state in opt.random_state:
        with tempfile.TemporaryDirectory() as tmp, pytest.MonkeyPatch.context() as mp:
            rec = record_fdr_steps(mp) if opt.parting else None
            runs, prec = run_both(Path(tmp), world, config, random_state=state)
            for who, (wf, psm, _) in runs.items():
                om = wf.optimization_manager
                print(
                    f"random state {state}, {who}: steps {steps_per_optimizer(wf)}, tolerances "
                    + ", ".join(f"{k} {getattr(om, k):.4f}" for k in TOLERANCES)
                    + f"; identified/false/targets/decoys {id_shares(wf.dia_data.cycle_rt, prec, psm)}; fragment m/z "
                    f"bias error {bias_error(wf, wf.spectral_library.fragment_df, planted):.4f} ppm; "
                    f"{wf.wall:.1f} s",
                    flush=True,
                )
            if rec is not None:
                print_first_parting(rec)


if __name__ == "__main__":
    main()
