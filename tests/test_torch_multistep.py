"""The three-step plan (transfer step -> library step -> MBR step) through
both CLIs on the CPU (``ALPHADIA_TORCH_DEVICE=cpu``), on the world of the
JAX package's ``tests/e2e/test_multistep_e2e.py`` (300 peptides, 6
windows, 350 cycles, seed 31, one decoy a target; the run as ``.npz``, the
library as a flat HDF) with that test's config and the MBR step enabled:

- the steps' directories and files: ``transfer/`` with the transfer
  library, ``peptdeep.transfer/models.pkl`` and ``stats.transfer.tsv``
  (JAX's columns), ``library/`` with ``speclib.mbr.hdf``, the output
  directory with ``precursors.parquet``;
- each step's ``frozen_config.yaml``: the transfer step's extras; the
  library and MBR steps' ``peptdeep_model_path`` (the transfer step's model
  directory) and tolerances (the transfer step's, the MBR step's from the
  library step), as JAX's plan forwards them;
- the fine-tuned models load and predict finite values in both packages;
- the MBR step's target precursors at 1% FDR overlap JAX's by Jaccard >=
  0.9 and their counts lie within 5% of each other (the transfer step's
  search parts from JAX's at the same state: ROADMAP §3).
"""

import json

import numpy as np
import pandas as pd
import pytest
import yaml

import alphadia_torch.cli as port_cli
import alphadia_tpu.cli as jax_cli

pytest_plugins = ("torch_port_plugin",)

JACCARD_MIN = 0.9
COUNT_REL = 0.05
CONFIG = {
    "general": {"random_state": 3, "save_figures": False, "transfer_step_enabled": True, "mbr_step_enabled": True},
    "calibration": {"batch_size": 150, "optimization_lock_target": 80, "min_steps": 2, "max_steps": 5},
    "search": {"target_ms1_tolerance": 10, "target_ms2_tolerance": 12, "target_rt_tolerance": 30},
    "transfer_learning": {"epochs": 6, "batch_size": 128},
    "tpu": {"selection_batch": 256, "scoring_batch": 256},
}


def _exit_code(run, argv) -> int:
    try:
        run(argv)
    except SystemExit as e:
        return e.code
    return 0


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    """Both CLIs' three-step plan on the same files: {"jax": out, "port": out}."""
    from alphadia_tpu.library.speclib import SpecLibFlat
    from alphadia_tpu.rawdata.source import save_npz
    from alphadia_tpu.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia

    tmp = tmp_path_factory.mktemp("multistep")
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(n_peptides=300, n_windows=6, n_cycles=350, seed=31))
    prec, frag = add_synthetic_decoys(prec, frag)
    raw, lib = tmp / "run_t.npz", tmp / "lib.hdf"
    save_npz(raw, spectra)
    SpecLibFlat(prec.drop(columns=["_truth_detectable", "_truth_rt"]), frag).save_hdf(lib)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALPHADIA_TORCH_DEVICE", "cpu")
        for who, run in (("jax", jax_cli.run), ("port", port_cli.run)):
            out[who] = tmp / who
            argv = ["-o", str(out[who]), "-f", str(raw), "-l", str(lib), "--config-dict", json.dumps(CONFIG)]
            assert _exit_code(run, argv) == 0, who
    return out


@pytest.mark.parametrize("who", ["jax", "port"])
def test_each_step_writes_its_files(plans, who):
    out = plans[who]
    transfer = out / "transfer"
    for name in ("speclib.transfer.parquet", "speclib.transfer.fragments.parquet", "stats.transfer.tsv",
                 "peptdeep.transfer/models.pkl", "precursors.parquet"):
        assert (transfer / name).exists(), name
    assert (out / "library" / "speclib.mbr.hdf").exists() and (out / "library" / "precursors.parquet").exists()
    assert (out / "precursors.parquet").exists() and (out / "stat.tsv").exists()
    jax_cols = list(pd.read_csv(plans["jax"] / "transfer" / "stats.transfer.tsv", sep="\t").columns)
    assert list(pd.read_csv(transfer / "stats.transfer.tsv", sep="\t").columns) == jax_cols
    assert "rt_r2" in jax_cols


def _frozen(out, step):
    return yaml.safe_load((out / step / "frozen_config.yaml").read_text())


def test_the_steps_forward_models_and_tolerances_as_jax(plans):
    for who, out in plans.items():
        model_dir = str(out / "transfer" / "peptdeep.transfer")
        t = _frozen(out, "transfer")
        assert t["transfer_library"]["enabled"] and t["transfer_learning"]["enabled"]
        lib, mbr = _frozen(out, "library"), _frozen(out, ".")
        for cfg in (lib, mbr):
            assert cfg["library_prediction"]["peptdeep_model_path"] == model_dir, who
        stat_t = pd.read_csv(out / "transfer" / "stat.tsv", sep="\t")
        stat_l = pd.read_csv(out / "library" / "stat.tsv", sep="\t")
        np.testing.assert_allclose(lib["search"]["target_ms2_tolerance"], stat_t["optimization.ms2_error"].median())
        np.testing.assert_allclose(mbr["search"]["target_ms2_tolerance"], stat_l["optimization.ms2_error"].median())
        assert mbr["library_path"] == str(out / "library" / "speclib.mbr.hdf")
        assert lib["general"]["save_mbr_library"] and mbr["search"]["target_num_candidates"] == 5


def test_the_tuned_models_load_in_both_packages(plans):
    from alphadia_torch.models.finetune import FinetuneManager
    from alphadia_tpu.models.finetune import FinetuneManager as JaxFinetuneManager

    seqs = ["PEPTIDEK", "ACDEFGHIK", "LVNEVTEFAK"]
    for who, out in plans.items():
        d = out / "transfer" / "peptdeep.transfer"
        for pred in (FinetuneManager.load(d, device="cpu").predict_rt(seqs), JaxFinetuneManager.load(d).predict_rt(seqs)):
            assert pred.shape == (3,) and np.isfinite(pred).all()
        np.testing.assert_allclose(FinetuneManager.load(d, device="cpu").predict_rt(seqs),
                                   JaxFinetuneManager.load(d).predict_rt(seqs), atol=1e-5)


def _ids(out) -> set:
    psm = pd.read_parquet(out / "precursors.parquet")
    sel = psm[(psm["precursor.qval"] <= 0.01) & (psm["precursor.decoy"] == 0)]
    return set(sel["precursor.idx"].tolist())


def test_the_mbr_steps_ids_match_jax(plans):
    want, got = _ids(plans["jax"]), _ids(plans["port"])
    assert len(want) > 100
    assert len(want & got) / len(want | got) >= JACCARD_MIN
    assert abs(len(got) - len(want)) <= COUNT_REL * len(want)
