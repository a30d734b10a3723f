"""Where the optimization steps part from JAX's after the peak store's
repair: the mass-error features of step 0's scoring on the workflow's
quarter world (1,500 peptides, 3 windows, 600 cycles, random state 1).

``tests/test_torch_workflow.py --random-state 1 --parting`` shows the two
packages' first FDR fits seeing the same candidates, a few of them with
mass-error features that differ; the features travel to the host rounded
to float16, where a difference of ~1e-5 ppm can cross a rounding boundary,
the fitted probabilities of one precursor's two candidates then tie within
0.5% at the third fit, and each package keeps another candidate for the RT
calibration. The mass errors come from the XIC's m/z plane: JAX's XLA path
(how the JAX package runs on the CPU) takes its per-cycle sums as
differences of float32 prefix sums, its Pallas kernel (how it runs on the
chip) and the port sum directly. Held here, on the step-0 candidates whose
mass errors differ most between the port and the XLA path:

- the port's features equal those of JAX's Pallas path in interpret mode
  within 1e-5 ppm, the XIC kernel's own tolerance for the m/z plane;
- the XLA path departs from both by more: the difference is the JAX
  package's own, between its CPU and its chip path.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import alphadia_tpu.ops.scoring as jax_scoring
from alphadia_torch.config import load_default_config
from alphadia_torch.convert import frame_from_pandas
from alphadia_torch.library.speclib import SpecLibFlat
from alphadia_torch.ops.scoring import score_candidates_batch
from alphadia_torch.rawdata.source import load_raw_file
from alphadia_torch.search.scoring import CandidateScoring
from alphadia_torch.workflow.managers import fdr_manager
from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow
from alphadia_tpu.ops.xic_pallas import extract_xic_pallas
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.search.scoring import FEATURE_COLUMNS
from test_torch_workflow import PHASE7_CONFIG, make_world

pytest_plugins = ("torch_port_plugin",)

WORLD = dict(n_peptides=1500, n_windows=3, n_cycles=600, noise_peaks_per_spectrum=80, seed=5, with_mobility=False)
RANDOM_STATE = 1
MASS_ERRORS = ("top_3_ms2_mass_error", "mean_ms2_mass_error", "weighted_mass_error", "mean_overlapping_mass_error")
N_CANDIDATES = 4
PPM_TOL = 1e-5
LIB_KEYS = (
    "frag_mz", "frag_valid", "frag_intensity", "frag_type", "frag_position", "iso_mz", "iso_intensity",
    "ms2_slot", "ms1_slot", "win_lo", "win_hi",
)


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def step0(tmp_path_factory):
    """The port's workflow stopped at its first FDR fit: the scoring driver
    and its first dispatched chunk (library rows and geometry) of step 0,
    and the store JAX's workflow builds from the same raw file."""
    tmp = tmp_path_factory.mktemp("scoring_tie")
    raw, prec, frag = make_world(tmp, WORLD)
    seen = []
    dispatch = CandidateScoring._dispatch_chunk

    def recording(self, dev, lib_dev, chunk, W):
        seen.append((self, {k: v.copy() for k, v in chunk.items()}, W, {k: v.cpu().numpy() for k, v in lib_dev.items()}))
        return dispatch(self, dev, lib_dev, chunk, W)

    def stop(*a, **k):
        raise _Stop()

    cfg = load_default_config()
    cfg.update_layer(PHASE7_CONFIG, name="test")
    cfg.update_layer({"output_directory": str(tmp / "out")}, name="output")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CandidateScoring, "_dispatch_chunk", recording)
        mp.setattr(fdr_manager.FDRManager, "fit_predict", stop)
        wf = PeptideCentricWorkflow("synthetic", cfg, random_state=RANDOM_STATE, device="cpu")
        wf.load(raw, SpecLibFlat(frame_from_pandas(prec), frame_from_pandas(frag)))
        with pytest.raises(_Stop):
            wf.search_parameter_optimization()
    return seen[0], JaxDiaData.from_spectra(load_raw_file(raw))


def _score(step0, rows, use_pallas=None):
    """Mass-error features of the chunk's ``rows``: the port's
    (``use_pallas`` None) or JAX's on its XLA or Pallas path."""
    (scoring, chunk, W, lib_np), jd = step0
    cfg = scoring.config
    lib = {k: lib_np[k][chunk["rows"][rows]] for k in LIB_KEYS}
    geo = {k: chunk[k][rows] for k in ("frame_center", "frame_start", "frame_stop")}
    static = dict(
        n_bins=jd.n_bins, bin_mz_min=jd.bin_mz_min, bin_width=jd.coarse_bin_width, slab=cfg.gather_slab, window_len=W,
        quant_window=cfg.quant_window, quant_all=cfg.quant_all, experimental_xic=cfg.experimental_xic,
        compute_dtype=cfg.compute_dtype,
    )
    cols = [FEATURE_COLUMNS.index(c) for c in MASS_ERRORS]
    if use_pallas is None:
        dev = scoring.dia.device_arrays(1, "cpu")
        t = {k: torch.from_numpy(v) for k, v in {**lib, **geo}.items()}
        out = score_candidates_batch(
            dev["peak_store"], dev["cell_start"], dev["cycle_rt"], *(t[k] for k in LIB_KEYS),
            cfg.quad_sigma, cfg.quad_delta_mu, t["frame_center"], t["frame_start"], t["frame_stop"],
            cfg.fragment_mz_tolerance, cfg.precursor_mz_tolerance, n_cycles=dev["n_cycles"], n_scan_bins=1, **static,
        )
        return out[0].numpy()[:, cols].astype(np.float64)
    B = len(rows)
    dev = jd.device_arrays()
    out = jax_scoring.score_candidates_batch(
        dev["peak_mz"], dev["peak_intensity"], dev["peak_packed"], dev["peak_scanbin"], dev["cell_start"],
        dev["cycle_rt"], *(lib[k] for k in LIB_KEYS), np.asarray(cfg.quad_sigma, np.float32),
        np.asarray(cfg.quad_delta_mu, np.float32), geo["frame_center"], geo["frame_start"], geo["frame_stop"],
        np.zeros(B, np.int32), np.ones(B, np.int32), np.zeros(B, np.float32),
        np.float32(cfg.fragment_mz_tolerance), np.float32(cfg.precursor_mz_tolerance),
        n_cycles=jd.n_cycles_dev, use_pallas=use_pallas, **static,
    )
    return np.asarray(out[0])[:, cols].astype(np.float64)


def test_mass_errors_follow_the_chip_path(step0, monkeypatch):
    (_, chunk, _, _), _ = step0
    everything = np.arange(len(chunk["rows"]))
    port_all, xla_all = _score(step0, everything), _score(step0, everything, use_pallas=False)
    rows = np.argsort(-np.abs(port_all - xla_all).max(axis=1))[:N_CANDIDATES]
    monkeypatch.setattr(jax_scoring, "extract_xic_pallas", functools.partial(extract_xic_pallas, interpret=True))
    pallas = _score(step0, rows, use_pallas=True)
    port, xla = port_all[rows], xla_all[rows]
    np.testing.assert_allclose(port, pallas, rtol=0, atol=PPM_TOL)
    assert np.abs(xla - pallas).max() > 10 * max(np.abs(port - pallas).max(), PPM_TOL / 10)
