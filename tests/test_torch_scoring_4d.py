"""``score_candidates_batch`` on ion-mobility data (``n_scan_bins`` > 1):
the port against the JAX function (its XLA path, ``use_pallas=False``, as
the JAX package's own CPU tests run it) on a 4D world, and the port's
scoring driver on the hand-built mobility run of
``tests/unit/test_scoring_golden_4d.py``, whose golden values hold for the
port too.

float32: every feature within the 3D scoring test's tolerance (2e-3 of
max(|value|, 1)), the five mass-error features within 0.06 ppm, and
``scan_com`` within 2e-3 bins. The 4D features (0, 3, 29, 30, 39) and
``scan_com`` are held alike and must be non-zero where JAX's are.
bfloat16: the 4D chains stay float32, so features 29, 30 and 39 and
``scan_com`` keep the float32 bounds; every other feature's median
deviation within the bf16 tolerances of ``tests/test_torch_scoring.py``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from alphadia_torch.convert import config_from_jax, diadata_from_jax, frame_from_pandas
from alphadia_torch.ops.scoring import score_candidates_batch
from alphadia_torch.search.scoring import LIB_KEYS, CandidateScoring
from alphadia_torch.search.selection import CandidateSelection, SelectionConfig
from alphadia_tpu.ops.scoring import score_candidates_batch as jax_score
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.search.scoring import FEATURE_COLUMNS, ScoringConfig
from alphadia_tpu.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia

sys.path.insert(0, str(Path(__file__).parent / "unit"))
import test_scoring_golden_4d as golden4d  # noqa: E402

pytest_plugins = ("torch_port_plugin",)

MASS_ERRORS = (
    "weighted_mass_deviation", "weighted_mass_error", "top_3_ms2_mass_error",
    "mean_ms2_mass_error", "mean_overlapping_mass_error",
)
SCAN_FEATURES = ("fragment_scan_correlation", "template_scan_correlation", "mobility_fwhm")
F32_REL = 2e-3
MASS_ERROR_PPM = 0.06
SCAN_COM_BINS = 2e-3
BF16_TOL = {name: 0.02 for name in FEATURE_COLUMNS}
BF16_TOL.update({k: 0.25 for k in MASS_ERRORS})
BF16_TOL.update(
    rt_observed=2e-3, mz_observed=1e-3, delta_frame_peak=0.05, base_width_rt=0.05,
    diff_b_y_ion_intensity=0.06,
)
GEO = ("frame_center", "frame_start", "frame_stop")
SCAN_GEO = ("scan_lo", "scan_hi", "mobility_width")


@pytest.fixture(scope="module")
def world():
    spectra, prec, frag = make_synthetic_dia(
        SyntheticConfig(n_peptides=200, n_windows=6, n_cycles=300, with_mobility=True, seed=17)
    )
    prec, frag = add_synthetic_decoys(prec, frag)
    jd = JaxDiaData.from_spectra(spectra, n_scan_bins=8, use_native=False)
    td = diadata_from_jax(jd)
    prec, frag = frame_from_pandas(prec), frame_from_pandas(frag)
    cands = CandidateSelection(td, prec, frag, SelectionConfig(rt_tolerance=60.0, candidate_count=2), device="cpu")()
    assert (cands["scan_stop"] > 1).any()
    return jd, td, prec, frag, cands


def run_both(world, compute_dtype):
    jd, td, prec, frag, cands = world
    cfg = ScoringConfig(batch_size=4096, collect_fragments=True, compute_dtype=compute_dtype)
    scoring = CandidateScoring(td, prec, frag, config_from_jax(cfg), device="cpu")
    lib = scoring._library_arrays()
    geo = scoring._candidate_geometry(cands)
    lib_args = [lib[k][geo["rows"]] for k in LIB_KEYS]
    static = dict(
        n_cycles=jd.n_cycles_dev, n_bins=jd.n_bins, bin_mz_min=jd.bin_mz_min,
        bin_width=jd.coarse_bin_width, n_scan_bins=jd.n_scan_bins, slab=cfg.gather_slab,
        window_len=geo["window_len"], quant_window=cfg.quant_window, quant_all=cfg.quant_all,
        experimental_xic=cfg.experimental_xic, compute_dtype=compute_dtype,
    )
    jdev = jd.device_arrays()
    ref = jax_score(
        jdev["peak_mz"], jdev["peak_intensity"], jdev["peak_packed"], jdev["peak_scanbin"],
        jdev["cell_start"], jdev["cycle_rt"], *lib_args,
        np.asarray(cfg.quad_sigma, np.float32), np.asarray(cfg.quad_delta_mu, np.float32),
        *(geo[k] for k in GEO + SCAN_GEO),
        np.float32(cfg.fragment_mz_tolerance), np.float32(cfg.precursor_mz_tolerance),
        use_pallas=False, **static,
    )
    dev = td.device_arrays(1, "cpu")
    got = score_candidates_batch(
        dev["peak_store"], dev["cell_start"], dev["cycle_rt"],
        *(torch.from_numpy(a) for a in lib_args), cfg.quad_sigma, cfg.quad_delta_mu,
        *(torch.from_numpy(geo[k]) for k in GEO),
        cfg.fragment_mz_tolerance, cfg.precursor_mz_tolerance,
        **{k: torch.from_numpy(geo[k]) for k in SCAN_GEO},
        **static,
    )
    return got, ref


def deviations(got, ref):
    """Per feature: (|got - ref|, |got - ref| / max(|ref|, 1))."""
    g = got[0].double().numpy()
    r = np.asarray(ref[0], np.float64)
    d = np.abs(g - r)
    return {name: (d[:, j], d[:, j] / np.maximum(np.abs(r[:, j]), 1.0)) for j, name in enumerate(FEATURE_COLUMNS)}


def check_scan_outputs(got, ref):
    g, r = got[0].numpy(), np.asarray(ref[0])
    for name in SCAN_FEATURES:
        j = FEATURE_COLUMNS.index(name)
        np.testing.assert_array_equal(g[:, j] != 0, r[:, j] != 0, err_msg=name)
        assert (r[:, j] != 0).mean() > 0.2, name
    com_g, com_r = got[2]["scan_com"].numpy(), np.asarray(ref[2]["scan_com"])
    np.testing.assert_allclose(com_g, com_r, rtol=0, atol=SCAN_COM_BINS)
    assert (com_r > 0).mean() > 0.2


@pytest.fixture(scope="module")
def f32_run(world):
    return run_both(world, "float32")


def test_world_batch_f32_4d(f32_run):
    got, ref = f32_run
    assert len(got[1]) > 300 and int(got[1].sum()) > 100
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for name, (absdev, reldev) in deviations(got, ref).items():
        if name in MASS_ERRORS:
            assert absdev.max() <= MASS_ERROR_PPM, (name, absdev.max())
        else:
            assert reldev.max() <= F32_REL, (name, reldev.max())
    # features 0 and 3 are the driver's to fill: 0 and 1e-6 in both
    for j, want in ((0, 0.0), (3, 1e-6)):
        assert (got[0][:, j].numpy() == np.float32(want)).all()
        assert (np.asarray(ref[0])[:, j] == np.float32(want)).all()


def test_scan_features_f32_4d(f32_run):
    got, ref = f32_run
    check_scan_outputs(got, ref)
    for k in ("valid", "mass_error", "height", "intensity", "correlation", "obs_intensity"):
        g, r = got[2][k].numpy(), np.asarray(ref[2][k])
        if g.dtype == bool:
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, rtol=F32_REL, atol=MASS_ERROR_PPM if k == "mass_error" else 1e-3, err_msg=k)


def test_world_batch_bf16_4d(world):
    got, ref = run_both(world, "bfloat16")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    valid = np.asarray(ref[1])
    for name, (absdev, reldev) in deviations(got, ref).items():
        if name in SCAN_FEATURES:
            assert reldev.max() <= F32_REL, (name, reldev.max())
        else:
            assert np.median(reldev[valid]) <= BF16_TOL[name], (name, np.median(reldev[valid]))
    check_scan_outputs(got, ref)


@pytest.fixture(scope="module")
def golden_psm():
    """The port's scoring driver on the hand-built mobility run."""
    jd = JaxDiaData.from_spectra(golden4d._build_spectra(), n_scan_bins=golden4d.S, use_native=False)
    td = diadata_from_jax(jd)
    frags = golden4d.FRAGS
    prec = {
        "precursor_idx": np.array([7], np.uint32), "charge": np.array([golden4d.CHARGE], np.uint8),
        "mz_library": np.array([golden4d.MONO_MZ], np.float32), "rt_library": np.array([8.0], np.float32),
        "flat_frag_start_idx": np.array([0], np.uint32), "flat_frag_stop_idx": np.array([len(frags)], np.uint32),
        "i_0": np.array([1.0], np.float32), "i_1": np.array([0.6], np.float32), "i_2": np.array([0.3], np.float32),
    }
    frag = {
        "mz_library": np.array([f[0] for f in frags], np.float32),
        "intensity": np.array([f[1] for f in frags], np.float32),
        "type": np.array([f[2] for f in frags], np.uint8),
        "position": np.array([f[3] for f in frags], np.uint8),
        "number": np.array([1, 2, 3], np.uint8), "charge": np.ones(3, np.uint8),
        "loss_type": np.zeros(3, np.uint8), "cardinality": np.ones(3, np.uint8),
    }
    cand = {
        "precursor_idx": np.array([7], np.int64), "rank": np.array([0], np.uint8),
        "score": np.array([1.0], np.float32), "frame_center": np.array([8], np.int64),
        "frame_start": np.array([2], np.int64), "frame_stop": np.array([14], np.int64),
        "scan_center": np.array([1], np.int64), "scan_start": np.array([0], np.int64),
        "scan_stop": np.array([golden4d.S], np.int64),
    }
    from alphadia_torch.search.scoring import ScoringConfig as TorchScoringConfig

    psm, _ = CandidateScoring(td, prec, frag, TorchScoringConfig(top_k_fragments=3, quant_window=3), device="cpu")(cand)
    assert len(psm["precursor_idx"]) == 1
    return {k: v[0] for k, v in psm.items()}


@pytest.mark.parametrize(
    "check",
    [
        golden4d.test_scan_correlations_golden,
        golden4d.test_mobility_fwhm_golden,
        golden4d.test_observed_mobility_golden,
        golden4d.test_base_width_mobility_golden,
        golden4d.test_frame_features_survive_4d,
    ],
    ids=lambda f: f.__name__,
)
def test_golden_4d(golden_psm, check):
    check(golden_psm)
