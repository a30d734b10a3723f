"""The transfer requant (``workflow/peptidecentric/transfer_requant_handler.py``)
against the JAX package on the CPU.

- The physics world of ``tests/integration/test_transfer_requant.py`` (the
  library's RT and MS2 from ``testing/physics.py``, the run planting its
  top 12 fragments): the port's workflow through ``extraction`` and
  ``requantify_fragments`` meets that test's assertions (one PSM row a
  candidate, the whole b/y space up to charge 2 at > 1.5x the scored set's
  fragments a precursor, ``flat_frag_*`` partitioning the new table, the
  requantified intensities correlating with the planted MS2 at a median
  > 0.5), and so does JAX's on the same library and run;
- ``TransferRequantHandler.requantify`` of both packages on one
  ``DiaData``, JAX's PSM frame and tolerances, under the identity
  calibration and under JAX's fitted calibration carried across: the
  re-indexed PSM rows equal, the fragment frame's indices equal, its
  intensity and correlation at the scoring tests' tolerance;
- ``_bucket_topk`` equal to JAX's.
"""

import numpy as np
import pandas as pd
import pytest

from alphadia_torch.convert import diadata_from_jax, frame_from_pandas
from torch_workflow_worlds import REQUANT_CONFIG, REQUANT_FASTA, REQUANT_RUN

pytest_plugins = ("torch_port_plugin",)

F32_REL = 1e-4  # the scoring tests' tolerances


def physics_flat_library(tmp):
    """The JAX test's library: digest -> prediction -> the physics' RT and
    MS2 -> isotopes; (physics, the planted flat library, the searched one
    with decoys), pandas frames."""
    from alphadia_tpu.library.decoy import DecoyGenerator
    from alphadia_tpu.library.digest import digest_fasta
    from alphadia_tpu.library.flatten import FlattenLibrary, InitFlatColumns
    from alphadia_tpu.library.harmonize import IsotopeGenerator, PrecursorInitializer
    from alphadia_tpu.models.prediction import SimplePrediction
    from alphadia_tpu.testing.physics import FRAG_COLS, PeptidePhysics

    physics = PeptidePhysics()
    fasta = tmp / "physics.fasta"
    fasta.write_text(REQUANT_FASTA)
    lib = SimplePrediction()(PrecursorInitializer()(digest_fasta([str(fasta)], missed_cleavages=1)))
    df = lib.precursor_df
    df["rt_norm"] = physics.rt_norm(df["sequence"].tolist())
    cols = list(lib.fragment_intensity_df.columns)
    inten = lib.fragment_intensity_df.to_numpy().copy()
    for seq, z, a, b in zip(df["sequence"], df["charge"], df["frag_start_idx"], df["frag_stop_idx"]):
        mat = physics.ms2_matrix(str(seq), int(z))
        block = np.zeros((int(b) - int(a), len(cols)), np.float32)
        for j, c in enumerate(cols):
            if c in FRAG_COLS:
                n = min(len(mat), len(block))
                block[:n, j] = mat[:n, FRAG_COLS.index(c)]
        inten[int(a) : int(b)] = block
    lib.fragment_intensity_df = pd.DataFrame(inten, columns=cols)
    lib = IsotopeGenerator()(lib)
    truth = InitFlatColumns()(FlattenLibrary()(lib.copy()))
    searched = InitFlatColumns()(FlattenLibrary()(DecoyGenerator("diann")(lib)))
    return physics, truth, searched


@pytest.fixture(scope="module")
def physics_runs(tmp_path_factory):
    """Both packages' workflows through ``extraction`` and
    ``requantify_fragments`` on the physics world."""
    from alphadia_torch.config import load_default_config
    from alphadia_torch.library.speclib import SpecLibFlat
    from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow
    from alphadia_tpu.config import load_default_config as jax_load_default_config
    from alphadia_tpu.rawdata.source import save_npz
    from alphadia_tpu.testing.synthetic import SyntheticConfig, make_run_from_library
    from alphadia_tpu.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow as JaxWorkflow

    tmp = tmp_path_factory.mktemp("physics")
    physics, truth, searched = physics_flat_library(tmp)
    spectra = make_run_from_library(truth.precursor_df, truth.fragment_df, SyntheticConfig(**REQUANT_RUN))
    raw = tmp / "run.npz"
    save_npz(raw, spectra)
    out = {}
    for who, load, make, lib in (
        ("jax", jax_load_default_config, lambda c: JaxWorkflow("physics", c), searched.copy()),
        ("port", load_default_config, lambda c: PeptideCentricWorkflow("physics", c, device="cpu"),
         SpecLibFlat(frame_from_pandas(searched.precursor_df), frame_from_pandas(searched.fragment_df))),
    ):
        cfg = load()
        cfg.update_layer({**REQUANT_CONFIG, "output_directory": str(tmp / who)}, name="requant")
        wf = make(cfg)
        wf.load(str(raw), lib)
        wf.search_parameter_optimization()
        psm, frag = wf.extraction()
        requant_psm, requant_frag = wf.requantify_fragments(psm)
        if who == "jax":
            psm, frag, requant_psm, requant_frag = map(frame_from_pandas, (psm, frag, requant_psm, requant_frag))
        out[who] = wf, psm, frag, requant_psm, requant_frag
    return physics, frame_from_pandas(searched.precursor_df), out


@pytest.mark.parametrize("who", ["port", "jax"])
def test_requant_meets_the_jax_integration_tests_assertions(physics_runs, who):
    """``tests/integration/test_transfer_requant.py``'s assertions, on the
    port and on JAX."""
    from torch_workflow_worlds import requant_checks, requant_gates

    physics, prec, runs = physics_runs
    _, psm, scored, requant_psm, requant_frag = runs[who]
    r = requant_checks(physics, prec, psm, scored, requant_psm, requant_frag)
    assert requant_gates(r) == [], r


class _IdentityCalibration:
    def predict(self, df, group):
        pass


class _Tolerances:
    def __init__(self, ms1_error, ms2_error):
        self.ms1_error, self.ms2_error = ms1_error, ms2_error


class _JaxCalibrationOnFrames:
    """JAX's fitted calibration manager predicting onto the port's column
    dicts: its fitted estimators carried across as they are."""

    def __init__(self, manager):
        self.manager = manager

    def predict(self, df, group):
        frame = pd.DataFrame({k: np.asarray(v) for k, v in df.items()})
        self.manager.predict(frame, group)
        for c in frame.columns:
            df[c] = frame[c].to_numpy()


@pytest.mark.parametrize("calibration", ["identity", "jax_fitted"])
def test_requantify_matches_jax_on_one_state(physics_runs, calibration):
    """Both handlers on JAX's run, JAX's PSM frame and JAX's final
    tolerances, under the identity calibration or JAX's fitted one."""
    from alphadia_torch.workflow.peptidecentric.transfer_requant_handler import TransferRequantHandler
    from alphadia_tpu.workflow.peptidecentric.transfer_requant_handler import (
        TransferRequantHandler as JaxTransferRequantHandler,
    )

    _, _, runs = physics_runs
    wf = runs["jax"][0]
    om = _Tolerances(wf.optimization_manager.ms1_error, wf.optimization_manager.ms2_error)
    jax_cm, port_cm = ((_IdentityCalibration(), _IdentityCalibration()) if calibration == "identity"
                       else (wf.calibration_manager, _JaxCalibrationOnFrames(wf.calibration_manager)))
    psm = pd.DataFrame(runs["jax"][1])
    theirs = JaxTransferRequantHandler(wf.config, jax_cm, om).requantify(wf.dia_data, psm)
    theirs = [frame_from_pandas(f) for f in theirs]
    ours = TransferRequantHandler(runs["port"][0].config, port_cm, om, device="cpu").requantify(
        diadata_from_jax(wf.dia_data), runs["jax"][1]
    )
    for name, a, b in (("psm", theirs[0], ours[0]), ("fragments", theirs[1], ours[1])):
        assert list(a) == list(b), (name, list(a), list(b))
        for c in a:
            x, y = np.asarray(a[c]), np.asarray(b[c])
            assert x.dtype == y.dtype or (x.dtype.kind in "OU" and y.dtype.kind in "OU"), (name, c, x.dtype, y.dtype)
            if name == "fragments" and c in ("intensity", "height", "correlation", "mass_error", "mz_observed"):
                atol = 1e-2 if c == "mass_error" else 1e-3
                np.testing.assert_allclose(y, x, rtol=F32_REL, atol=atol, err_msg=c)
            elif x.dtype.kind in "OU":
                assert [str(v) for v in x] == [str(v) for v in y], (name, c)
            else:
                assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), (name, c)
    assert len(ours[1]["precursor_idx"]) > 1.5 * len(runs["jax"][2]["precursor_idx"])


def test_bucket_topk_matches_jax():
    from alphadia_torch.workflow.peptidecentric.transfer_requant_handler import _bucket_topk
    from alphadia_tpu.workflow.peptidecentric.transfer_requant_handler import _bucket_topk as jax_bucket_topk

    for n in list(range(0, 300)) + [1000]:
        assert _bucket_topk(n) == jax_bucket_topk(n)
