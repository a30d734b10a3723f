"""The port's peptide property prediction against the JAX package's, on the
CPU, on identical numpy inputs.

- ``encode_sequences`` equal exactly (tokens and modification masses,
  unknown modifications, N-terminal sites, sequences past ``MAX_LEN``).
- Each of the four models (RT, MS2, mobility, charge) against flax
  ``apply`` at atol 1e-5, rtol 1e-5, with the packaged weights and with a
  directory that JAX's ``FinetuneManager.save`` wrote after seeded noise was
  added to them (what a transfer step leaves in ``peptdeep_model_path``);
  ``property_models_from_jax`` refuses a parameter it does not know, the
  unpickler every global but numpy's.
- ``FinetuneManager``'s four predictions, batched with a padded tail.
- ``SimplePrediction`` with the packaged weights, with a model directory
  without ``models.pkl`` (the heuristic baselines) and with
  ``predict_charge`` (the rows kept equal exactly), and its warnings.
- ``SearchStep.load_library`` from a FASTA: the flat library against JAX's.
- ``make_run_from_library``: the spectra equal JAX's bit for bit, 3D and 4D.
- Both CLIs library-free on the world of
  ``tests/e2e/test_library_free_e2e.py``: the IDs at 1% FDR overlap by
  Jaccard >= 0.95.
- The packaged ``models.pkl`` is the JAX package's, byte for byte.

Run as a script it builds the inputs of ``chip_smoke.py`` phase [10a] (the
port's CPU path), prints their sha256 and runs the JAX package's CLI on
them at the given random states, printing the readings phase [10a] gates
against, one JSON line a state (~20 min a state on 8 cores):

    PYTHONPATH=.:tests python tests/test_torch_prediction.py --random-state 0 1 2
"""

import hashlib
import json
import logging
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import alphadia_torch.cli as port_cli
import alphadia_torch.search_step as port_step
import alphadia_tpu.cli as jax_cli
import alphadia_tpu.search_step as jax_step
from alphadia_torch.convert import frame_from_pandas, property_models_from_jax
from alphadia_torch.library.digest import digest_fasta
from alphadia_torch.library.harmonize import PrecursorInitializer
from alphadia_torch.models import property_models as port_models
from alphadia_torch.models.finetune import FinetuneManager, load_models_pickle
from alphadia_torch.models.prediction import PACKAGED_MODELS, SimplePrediction, group_max
from alphadia_torch.testing.fasta import write_fasta
from alphadia_tpu.library.digest import digest_fasta as jax_digest_fasta
from alphadia_tpu.library.harmonize import PrecursorInitializer as JaxPrecursorInitializer
from alphadia_tpu.models import property_models as jax_models
from alphadia_tpu.models.finetune import FinetuneManager as JaxFinetuneManager
from alphadia_tpu.models.prediction import SimplePrediction as JaxSimplePrediction
from torch_workflow_worlds import LIBRARY_FREE_WORLD, library_free_readings, write_library_free_inputs

pytest_plugins = ("torch_port_plugin",)

JAX_PACKAGED = Path(jax_models.__file__).parents[1] / "constants" / "weights" / "peptdeep_default"

TOL = dict(atol=1e-5, rtol=1e-5)
JACCARD_MIN = 0.95
MODS = ["", "Oxidation@M", "Carbamidomethyl@C", "Acetyl@Protein_N-term;Oxidation@M", "Unknown@K", "Phospho@S"]


def _sequences(n: int, seed: int):
    """Seeded peptides with modifications at real sites, some past MAX_LEN."""
    rng = np.random.default_rng(seed)
    aa = np.array(list(port_models.VOCAB[:-1]))
    seqs, mods, sites, charges = [], [], [], []
    for i in range(n):
        s = "".join(rng.choice(aa, int(rng.integers(7, 41))))
        m = MODS[i % len(MODS)]
        names, where = [], []
        for name in [x for x in m.split(";") if x]:
            if name.endswith("Protein_N-term"):
                names.append(name), where.append("0")
                continue
            site = s.find(name.split("@")[1])
            if site >= 0:
                names.append(name), where.append(str(site + 1))
        seqs.append(s), mods.append(";".join(names)), sites.append(";".join(where))
        charges.append(int(rng.integers(1, 7)))
    return seqs, mods, sites, np.array(charges, np.int32)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{"packaged": directory, "perturbed": a directory JAX saved}."""
    manager = JaxFinetuneManager.load(str(JAX_PACKAGED))
    rng = np.random.default_rng(11)
    manager.variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(0, 0.05, np.shape(a)).astype(np.float32)), manager.variables
    )
    out = tmp_path_factory.mktemp("perturbed")
    manager.save(out)
    return {"packaged": str(JAX_PACKAGED), "perturbed": str(out)}


def test_packaged_weights_are_the_jax_packages():
    digest = [hashlib.sha256((p / "models.pkl").read_bytes()).hexdigest() for p in (PACKAGED_MODELS, JAX_PACKAGED)]
    assert digest[0] == digest[1]


def test_encode_sequences_matches():
    seqs, mods, sites, _ = _sequences(200, 1)
    for args in ((seqs,), (seqs, mods, sites)):
        a, b = jax_models.encode_sequences(*args), port_models.encode_sequences(*args)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert np.abs(b[1]).max() > 0  # the modification channel is exercised


def _flax(name, variables, tokens, mod_mass, charge):
    if name == "rt":
        return jax_models.RTModel().apply(variables, tokens, mod_mass)
    if name == "charge":
        return jax_models.ChargeModel().apply(variables, tokens, mod_mass)
    if name == "ccs":
        return jax_models.MobilityModel().apply(variables, tokens, mod_mass, charge)
    return jax_models.MS2Model().apply(variables, tokens, mod_mass, charge, 27.0)


def _torch(name, model, tokens, mod_mass, charge):
    t, m, c = torch.from_numpy(tokens), torch.from_numpy(mod_mass), torch.from_numpy(charge)
    with torch.inference_mode():
        if name in ("rt", "charge"):
            return model(t, m).numpy()
        if name == "ccs":
            return model(t, m, c).numpy()
        return model(t, m, c, 27.0).numpy()


@pytest.mark.parametrize("which", ["packaged", "perturbed"])
@pytest.mark.parametrize("name", ["rt", "ms2", "ccs", "charge"])
def test_model_matches_flax(weights, which, name):
    variables = load_models_pickle(f"{weights[which]}/models.pkl")["variables"]
    seqs, mods, sites, charge = _sequences(300, 2)
    tokens, mod_mass = port_models.encode_sequences(seqs, mods, sites)
    model = port_models.MODEL_OF[name]()
    model.load_state_dict(property_models_from_jax({name: variables[name]})[name])
    want = np.asarray(_flax(name, variables[name], tokens, mod_mass, charge))
    got = _torch(name, model.eval(), tokens, mod_mass, charge)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **TOL)


def test_unknown_parameters_and_globals_are_refused(tmp_path):
    variables = load_models_pickle(f"{JAX_PACKAGED}/models.pkl")["variables"]
    extra = {"params": {**variables["rt"]["params"], "Dense_2": {"kernel": np.zeros((1, 1), np.float32)}}}
    with pytest.raises(KeyError, match="Dense_2"):
        property_models_from_jax({"rt": extra})
    (tmp_path / "models.pkl").write_bytes(pickle.dumps({"variables": {}, "metrics": {"when": logging.Logger}}))
    with pytest.raises(pickle.UnpicklingError, match="logging.Logger"):
        FinetuneManager.load(tmp_path, device="cpu")


@pytest.mark.parametrize("which", ["packaged", "perturbed"])
def test_manager_predictions_match(weights, which, monkeypatch):
    # a small batch, so that the padded tail runs too
    monkeypatch.setattr(FinetuneManager, "PREDICT_BATCH", 64)
    monkeypatch.setattr(JaxFinetuneManager, "PREDICT_BATCH", 64)
    ours, theirs = FinetuneManager.load(weights[which], device="cpu"), JaxFinetuneManager.load(weights[which])
    seqs, mods, sites, charge = _sequences(150, 3)
    for method, args in (
        ("predict_rt", (seqs, mods, sites)),
        ("predict_charge", (seqs, mods, sites)),
        ("predict_mobility", (seqs, mods, sites, charge)),
        ("predict_ms2", (seqs, mods, sites, charge)),
    ):
        got, want = getattr(ours, method)(*args), getattr(theirs, method)(*args)
        assert got.shape == want.shape, method
        np.testing.assert_allclose(got, want, **TOL, err_msg=method)


def test_group_max_is_pandas_transform():
    rng = np.random.default_rng(4)
    keys = rng.choice(np.array(["a|", "b|x", "c|", "d|y"]), 500)
    values = rng.random(500).astype(np.float32)
    want = pd.Series(values).groupby(keys).transform("max").to_numpy()
    np.testing.assert_array_equal(group_max(keys, values), want)


# ---------------------------------------------------------------------------
# SimplePrediction
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    return write_fasta(tmp_path_factory.mktemp("fasta") / "db.fasta", 12, seed=3)


def _predict(fasta, **kw):
    jlib = JaxSimplePrediction(**kw)(JaxPrecursorInitializer()(jax_digest_fasta([str(fasta)])))
    plib = SimplePrediction(**kw, device="cpu")(PrecursorInitializer()(digest_fasta([str(fasta)])))
    return jlib, plib


def _frames_agree(jdf: pd.DataFrame, pdf: dict):
    assert list(jdf.columns) == list(pdf)
    for c in jdf.columns:
        a, b = jdf[c].to_numpy(), pdf[c]
        if a.dtype.kind == "f":
            assert a.dtype == b.dtype, c
            np.testing.assert_allclose(b, a, **TOL, err_msg=c)
        elif b.dtype == object:
            assert list(a) == list(b), c
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), c


@pytest.mark.parametrize(
    "case",
    ["packaged", "heuristic", "predict_charge", "fragment_types"],
)
def test_simple_prediction_matches(fasta, tmp_path, case):
    kw = {
        "packaged": {},
        "heuristic": {"model_path": str(tmp_path)},  # no models.pkl there
        "predict_charge": {"predict_charge": True, "min_charge_probability": 0.5},
        "fragment_types": {"fragment_types": ("b", "y"), "max_fragment_charge": 1, "nce": 30.0},
    }[case]
    jlib, plib = _predict(fasta, **kw)
    _frames_agree(jlib.precursor_df, plib.precursor_df)
    assert list(jlib.fragment_mz_df.columns) == plib.charged_frag_types
    np.testing.assert_array_equal(plib.fragment_mz, jlib.fragment_mz_df.to_numpy())
    np.testing.assert_allclose(plib.fragment_intensity, jlib.fragment_intensity_df.to_numpy(), **TOL)
    if case == "predict_charge":  # the filter dropped rows, and the same ones
        assert len(plib.precursor_df["charge"]) < len(digest_fasta([str(fasta)]).precursor_df["charge"])


def test_simple_prediction_warnings(fasta, caplog):
    with caplog.at_level(logging.WARNING):
        step = SimplePrediction(model_type="phospho", predict_charge=True, device="cpu")
        lib = PrecursorInitializer()(digest_fasta([str(fasta)]))
        lib.calc_fragment_mz()
        n = len(lib.precursor_df["charge"])
        step(lib)
    text = caplog.text
    assert "peptdeep_model_type 'phospho' is not packaged" in text
    assert "predict_charge ignored" in text
    assert step.model_type == "generic" and len(lib.precursor_df["charge"]) == n


# ---------------------------------------------------------------------------
# the search step's library from a FASTA, and the CLI
# ---------------------------------------------------------------------------
def test_load_library_from_fasta_matches_jax(fasta, tmp_path):
    config = {"library_path": None, "fasta_paths": [str(fasta)], "library_prediction": {"enabled": True}}
    theirs = jax_step.SearchStep(str(tmp_path / "jax"), config=config).load_library()
    ours = port_step.SearchStep(str(tmp_path / "port"), config=config, device="cpu").load_library()
    jp, pp = frame_from_pandas(theirs.precursor_df), ours.precursor_df
    assert list(jp) == list(pp)
    for c in jp:
        if jp[c].dtype.kind == "f":
            np.testing.assert_allclose(pp[c], jp[c], **TOL, err_msg=c)
        else:
            assert pp[c].dtype == jp[c].dtype and list(pp[c]) == list(jp[c]), c
    jf, pf = frame_from_pandas(theirs.fragment_df), ours.fragment_df
    assert list(jf) == list(pf)
    # the top-k fragments of a precursor may differ only where two
    # intensities tie within the tolerance; count those precursors
    same = np.ones(len(jp["precursor_idx"]), bool)
    for i, (a, b) in enumerate(zip(jp["flat_frag_start_idx"], jp["flat_frag_stop_idx"])):
        rows = slice(int(a), int(b))
        same[i] = all(np.array_equal(jf[c][rows], pf[c][rows]) for c in jf if jf[c].dtype.kind != "f")
        if not same[i]:
            inten = np.sort(jf["intensity"][rows])
            assert np.diff(inten).min() <= 2 * TOL["atol"], i
        np.testing.assert_allclose(np.sort(pf["intensity"][rows]), np.sort(jf["intensity"][rows]), **TOL)
    assert (~same).sum() <= 0.001 * len(same), f"{(~same).sum()} precursors with another top-k choice"


LIBRARY_FREE_E2E_FASTA = """>sp|P001|PROT1 GN=G1
MKWVTFISLLFLFSSAYSRGVFRRDAHKSEVAHRFKDLGEENFKALVLIAFAQYLQQCPFEDHVKLVNEVTEFAK
>sp|P002|PROT2 GN=G2
MTEYKLVVVGAGGVGKSALTIQLIQNHFVDEYDPTIEDSYRKQVVIDGETCLLDILDTAGQEEYSAMRDQYMRTGEGFLCVFAINNTK
>sp|P003|PROT3 GN=G3
MGLSDGEWQLVLNVWGKVEADIPGHGQEVLIRLFKGHPETLEKFDKFKHLKSEDEMKASEDLKKHGATVLTALGGILKKKGHHEAEIKPLAQSHATK
>sp|P004|PROT4 GN=G4
MSKGEELFTGVVPILVELDGDVNGHKFSVSGEGEGDATYGKLTLKFICTTGKLPVPWPTLVTTFSYGVQCFSR
>sp|P005|PROT5 GN=G5
MAHHHHHHVGTGSNITEEQLDAIAKELSERLDVAQESIRLAKEVANETKTAEDKLNALQDKLSALQAELAEAQK
"""
LIBRARY_FREE_E2E_OVERRIDES = {
    "general": {"random_state": 9, "save_figures": False},
    "library_prediction": {"enabled": True, "missed_cleavages": 1},
    "calibration": {"batch_size": 200, "optimization_lock_target": 30, "min_steps": 2, "max_steps": 5},
    "search": {"target_ms1_tolerance": 10, "target_ms2_tolerance": 12, "target_rt_tolerance": 60},
    "search_initial": {"rt_tolerance": 0.5},
    "tpu": {"selection_batch": 256, "scoring_batch": 256},
}


@pytest.mark.parametrize("with_mobility", [False, True], ids=["3d", "4d"])
def test_make_run_from_library_matches_jax(tmp_path, with_mobility):
    """The generator that plants a flat library equals the JAX package's:
    the same spectra, bit for bit, from the same frames and seed."""
    from torch_workflow_worlds import predicted_library

    from alphadia_torch.testing.synthetic import SyntheticConfig, make_run_from_library
    from alphadia_tpu.testing.synthetic import SyntheticConfig as JaxSyntheticConfig
    from alphadia_tpu.testing.synthetic import make_run_from_library as jax_make_run_from_library

    fasta = tmp_path / "test.fasta"
    fasta.write_text(LIBRARY_FREE_E2E_FASTA)
    flat = predicted_library([fasta])
    kw = dict(n_windows=4, n_cycles=120, noise_peaks_per_spectrum=20, seed=5, detectable_fraction=0.9,
              with_mobility=with_mobility)
    ours = make_run_from_library(flat.precursor_df, flat.fragment_df, SyntheticConfig(**kw))
    theirs = jax_make_run_from_library(
        pd.DataFrame(flat.precursor_df), pd.DataFrame(flat.fragment_df), JaxSyntheticConfig(**kw)
    )
    fields = ("rt", "ms_level", "isolation_lower_mz", "isolation_upper_mz", "peak_start_idx", "peak_stop_idx", "mz",
              "intensity") + (("mobility",) if with_mobility else ())
    for f in fields:
        a, b = getattr(theirs, f), getattr(ours, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert len(ours.mz) > 20 * len(ours.rt)  # planted peaks beside the noise


def _exit_code(run, argv) -> int:
    try:
        run(argv)
    except SystemExit as e:
        return e.code
    return 0


@pytest.fixture(scope="module")
def library_free_e2e(tmp_path_factory):
    """Both CLIs library-free on the world of the JAX package's e2e test:
    the digest and the packaged models' library planted in a 6-window,
    350-cycle run (seed 5), the run and the FASTA searched."""
    from torch_workflow_worlds import predicted_library

    from alphadia_torch.testing.mzml_writer import write_mzml
    from alphadia_torch.testing.synthetic import SyntheticConfig, make_run_from_library

    tmp = tmp_path_factory.mktemp("library_free")
    fasta = tmp / "test.fasta"
    fasta.write_text(LIBRARY_FREE_E2E_FASTA)
    flat = predicted_library([fasta], missed_cleavages=1)
    cfg = SyntheticConfig(n_windows=6, n_cycles=350, noise_peaks_per_spectrum=40, seed=5, detectable_fraction=0.9)
    write_mzml(tmp / "run.mzML", make_run_from_library(flat.precursor_df, flat.fragment_df, cfg))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALPHADIA_TORCH_DEVICE", "cpu")
        for who, run in (("jax", jax_cli.run), ("port", port_cli.run)):
            argv = ["-o", str(tmp / who), "-f", str(tmp / "run.mzML"), "--fasta", str(fasta),
                    "--config-dict", json.dumps(LIBRARY_FREE_E2E_OVERRIDES)]
            assert _exit_code(run, argv) == 0, who
            out[who] = pd.read_parquet(tmp / who / "precursors.parquet")
    return out, set(flat.precursor_df["sequence"])


def test_library_free_cli_matches_jax(library_free_e2e):
    out, digest_sequences = library_free_e2e

    def ids(psm):
        sel = psm[(psm["precursor.qval"] <= 0.01) & (psm["precursor.decoy"] == 0)]
        return set(zip(sel["precursor.sequence"], sel["precursor.mods"], sel["precursor.charge"]))

    a, b = ids(out["jax"]), ids(out["port"])
    assert len(b) > 10
    assert {s for s, _, _ in b} <= digest_sequences
    assert out["port"]["pg.name"].notna().all()
    assert len(a & b) / len(a | b) >= JACCARD_MIN


# ---------------------------------------------------------------------------
# the JAX readings of chip_smoke.py phase [10a]
# ---------------------------------------------------------------------------
def main():
    import argparse
    import os
    import tempfile
    from pathlib import Path

    ap = argparse.ArgumentParser(description="the JAX CLI library-free on the inputs of phase [10a]")
    ap.add_argument("--random-state", type=int, nargs="+", default=[0])
    ap.add_argument("--port", action="store_true", help="also run the port's CLI on the CPU")
    opt = ap.parse_args()
    os.environ["ALPHADIA_TORCH_DEVICE"] = "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fasta, raw, truth, cycle_rt = write_library_free_inputs(tmp, LIBRARY_FREE_WORLD)
        print(json.dumps({
            "fasta_sha256": hashlib.sha256(fasta.read_bytes()).hexdigest(),
            "mzml_sha256": hashlib.sha256(raw.read_bytes()).hexdigest(),
            "targets_planted": int(truth["_truth_detectable"].sum()), "targets": len(truth["charge"]),
        }), flush=True)
        for state in opt.random_state:
            for who, run in (("jax", jax_cli.run), ("port", port_cli.run))[: 2 if opt.port else 1]:
                out = tmp / f"{who}_{state}"
                argv = ["-o", str(out), "-f", str(raw), "--fasta", str(fasta), "--config-dict",
                        json.dumps({"general": {"random_state": state, "save_figures": False},
                                    "library_prediction": {"enabled": True}})]
                code = _exit_code(run, argv)
                print(json.dumps({"who": who, "random_state": state, "exit": code,
                                  **(library_free_readings(out, truth, cycle_rt) if code == 0 else {})}), flush=True)


if __name__ == "__main__":
    main()
