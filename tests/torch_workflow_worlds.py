"""The small worlds and configs of the workflow tests, and the port's
workflow run on one of them; imports nothing of JAX, so that the card tests
use it too.

The 3D world and config are those of ``tests/integration/test_workflow.py``,
the 4D ones those of ``tests/integration/test_workflow_4d.py``.
"""

from __future__ import annotations

import time

WORLDS = {
    "3d": dict(
        world=dict(n_peptides=400, n_windows=6, n_cycles=400, seed=11, lib_ppm_bias=5.0, lib_rt_sigma=10.0),
        config={
            "general": {"random_state": 42, "save_figures": False},
            "calibration": {"batch_size": 150, "optimization_lock_target": 100, "min_steps": 2, "max_steps": 6},
            "search": {"target_ms1_tolerance": 10, "target_ms2_tolerance": 12, "target_rt_tolerance": 30},
            "search_initial": {"ms1_tolerance": 25, "ms2_tolerance": 25, "rt_tolerance": 0.3},
            "tpu": {"selection_batch": 256, "scoring_batch": 256},
        },
    ),
    "4d": dict(
        world=dict(
            n_peptides=300, n_windows=6, n_cycles=300, seed=23, lib_ppm_bias=5.0, lib_rt_sigma=10.0,
            with_mobility=True,
        ),
        config={
            "general": {"random_state": 7, "save_figures": False},
            "calibration": {"batch_size": 150, "optimization_lock_target": 80, "min_steps": 2, "max_steps": 5},
            "search": {
                "target_ms1_tolerance": 10, "target_ms2_tolerance": 12, "target_rt_tolerance": 30,
                "target_mobility_tolerance": 0.1,
            },
            "search_initial": {"ms1_tolerance": 25, "ms2_tolerance": 25, "rt_tolerance": 0.3},
            "tpu": {"selection_batch": 256, "scoring_batch": 256},
        },
    ),
}

TOLERANCES = ("ms1_error", "ms2_error", "rt_error", "mobility_error")


def record_optimizers(wf):
    """Keep the optimizer groups the loop builds in ``wf.ordered_optimizers``
    (works on either package's workflow)."""
    handler = wf.optimization_handler
    build = handler._get_ordered_optimizers

    def recording():
        wf.ordered_optimizers = build()
        return wf.ordered_optimizers

    handler._get_ordered_optimizers = recording


def steps_per_optimizer(wf) -> dict:
    return {o.parameter_name: o._num_prev_optimizations for group in wf.ordered_optimizers for o in group}


def target_ids(psm: dict, fdr: float = 0.01) -> set:
    return set(psm["precursor_idx"][(psm["qval"] <= fdr) & (psm["decoy"] == 0)].tolist())


def run_workflow(make_workflow, cfg, raw_path, library, out_dir):
    """load -> search_parameter_optimization -> extraction; the workflow
    (with ``wall`` set) and its PSMs and fragments."""
    cfg.update_layer({"output_directory": str(out_dir)}, name="output")
    wf = make_workflow(cfg)
    t0 = time.perf_counter()
    wf.load(raw_path, library)
    record_optimizers(wf)
    wf.search_parameter_optimization()
    psm, frag = wf.extraction()
    wf.wall = time.perf_counter() - t0
    return wf, psm, frag


def run_port(tmp, kind: str, device, random_state=None):
    """The port's workflow on a small world (the port's generator, which
    gives the JAX package's arrays): (workflow, psm, fragments,
    precursors)."""
    from alphadia_torch.config import load_default_config
    from alphadia_torch.library.speclib import SpecLibFlat
    from alphadia_torch.rawdata import save_npz
    from alphadia_torch.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
    from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow

    spec = WORLDS[kind]
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(**spec["world"]))
    prec, frag = add_synthetic_decoys(prec, frag)
    raw_path = tmp / f"{kind}.npz"
    save_npz(raw_path, spectra)
    cfg = load_default_config()
    cfg.update_layer(spec["config"], name="test")
    wf, psm, fragments = run_workflow(
        lambda c: PeptideCentricWorkflow("synthetic", c, random_state=random_state, device=device),
        cfg, str(raw_path), SpecLibFlat(prec, frag), tmp / f"out_{device}",
    )
    return wf, psm, fragments, prec


def compare_runs(a, b) -> dict:
    """Steps per optimizer of both, the largest relative tolerance
    difference, and the Jaccard overlap of the target IDs at 1% FDR."""
    (wf_a, psm_a), (wf_b, psm_b) = a, b
    rel = max(
        abs(getattr(wf_a.optimization_manager, k) - getattr(wf_b.optimization_manager, k))
        / abs(getattr(wf_b.optimization_manager, k))
        for k in TOLERANCES
    )
    ia, ib = target_ids(psm_a), target_ids(psm_b)
    return {
        "steps": (steps_per_optimizer(wf_a), steps_per_optimizer(wf_b)),
        "tolerance_rel": rel,
        "jaccard": len(ia & ib) / max(len(ia | ib), 1),
        "ids": (len(ia), len(ib)),
    }
