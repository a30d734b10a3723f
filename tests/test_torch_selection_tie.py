"""The first parting of the port's optimization steps from JAX's: one
decoy's step-0 candidate on the search step's quarter world.

On the 3D world of ``tests/test_torch_search_step.py``'s script mode (1,500
peptides, 3 windows, 600 cycles, random state 2) the first FDR fit of the
two packages saw the same candidates but one: precursor 2307, whose rank-0
candidate took cycle 461 in JAX and cycle 409 in the port. The cause is
the peak store, not the selection op. JAX's ``RawFileManager`` builds the
store with its native builder, which keeps a cell's peaks in the spectrum's
m/z order, ghosts among them; the JAX package's numpy builder, which the
port had copied, puts a cell's ghosts after its canonical peaks. The step-0
window covers the whole run in 512 coarse cycles, the slab of this
precursor's queries overflows ``gather_slab`` and is cut, and the per-cycle
sums depend on the order of the peaks: on the numpy builder's store JAX
picks the port's old apex too.

Held here, on the batch row of precursor 2307 as the port's step 0
prepares it (the inputs equal JAX's, ``tests/test_torch_search_step.py``):

- the port's store equals the store JAX's workflow builds, array for array;
- on it, JAX's ``select_candidates_batch`` on its XLA path (as it runs on
  the CPU), the same through the Pallas kernel in interpret mode (as it runs
  on the chip) and the port's CPU path give one candidate: the same apex
  and extents, scores within 1e-6;
- that apex is cycle 461, and on the numpy builder's store it is 409.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import alphadia_tpu.ops.selection as jax_selection
from alphadia_torch.ops.selection import select_candidates_batch
from alphadia_torch.ops.smooth import gaussian_kernel_1d, rt_kernel_sigma
from alphadia_torch.search.selection import CandidateSelection
from alphadia_torch.search_step import SearchStep
from alphadia_torch.utils.device import bucket_window
from alphadia_tpu.native import build_peak_store_native
from alphadia_tpu.ops.xic_pallas import extract_xic_pallas
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.rawdata import load_raw_file as jax_load_raw_file
from torch_workflow_worlds import CLI_WORLD, write_search_inputs

pytest_plugins = ("torch_port_plugin",)

PRECURSOR = 2307
RANDOM_STATE = 2
SCORE_TOL = 1e-6
STORE_ARRAYS = ("peak_mz", "peak_intensity", "peak_is_ghost", "peak_scanbin", "cell_start")


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def step0(tmp_path_factory):
    """The port's step-0 ``CandidateSelection`` (stopped before it runs), the
    store JAX's workflow builds from the same mzML, and that of JAX's numpy
    builder."""
    tmp = tmp_path_factory.mktemp("tie")
    raw, lib, _, _ = write_search_inputs(tmp, CLI_WORLD)
    seen = []

    def stop(self):
        seen.append(self)
        raise _Stop()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CandidateSelection, "_submit", stop)
        step = SearchStep(str(tmp / "out"), config={
            "library_path": str(lib), "raw_paths": [str(raw)],
            "general": {"random_state": RANDOM_STATE, "fail_fast": True},
        }, device="cpu")
        with pytest.raises(_Stop):
            step.run()
    spectra = jax_load_raw_file(str(raw))
    return seen[0], JaxDiaData.from_spectra(spectra), JaxDiaData.from_spectra(spectra, use_native=False)


def _batch(sel):
    """The precursor's row of the step-0 batch, coarsened as both drivers
    coarsen a wide window, and the op's static arguments."""
    cfg, dia = sel.config, sel.dia
    arrays = sel._prepare_batch_arrays()
    stride = 1
    while arrays["window_len"] // stride > 512:
        stride *= 2
    W = bucket_window(max(-(-arrays["window_len"] // stride), 32, cfg.kernel_size))
    n_cycles = dia.device_arrays(stride, "cpu")["n_cycles"]
    row = np.nonzero(sel.precursor["precursor_idx"] == PRECURSOR)[0]
    batch = {k: arrays[k][row] for k in ("frag_slot", "frag_mz", "iso_slot", "iso_mz", "n_valid_fragments")}
    batch["cycle_start"] = np.clip(arrays["cycle_start"][row] // stride, 0, max(n_cycles - W, 0)).astype(np.int32)
    min_rt = max(1, cfg.min_size_rt // stride)
    static = dict(
        n_cycles=n_cycles, n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min, bin_width=dia.coarse_bin_width,
        slab=cfg.gather_slab, window_len=W, kernel_size=cfg.kernel_size, candidate_count=cfg.candidate_count,
        min_size_rt=min_rt, max_size_rt=max(min_rt + 1, -(-cfg.max_size_rt // stride)), f_rt=cfg.f_rt,
        center_fraction=cfg.center_fraction, join_close_candidates=cfg.join_close_candidates,
        join_cycle_threshold=cfg.join_close_candidates_cycle_threshold,
        peak_cycle_tolerance=max(1, cfg.peak_cycle_tolerance // stride), cycle_stride=stride,
    )
    kernel = gaussian_kernel_1d(cfg.kernel_size, rt_kernel_sigma(cfg.fwhm_rt, cfg.sigma_scale_rt, dia.cycle_time * stride))
    return batch, static, kernel, stride


def _jax(sel, store, use_pallas: bool) -> dict:
    batch, static, kernel, stride = _batch(sel)
    dev = store.device_arrays(stride)
    out = jax_selection.select_candidates_batch(
        dev["peak_mz"], dev["peak_intensity"], dev["peak_packed"], dev["cell_start"],
        batch["frag_slot"], batch["frag_mz"], batch["iso_slot"], batch["iso_mz"], batch["cycle_start"], kernel,
        np.float32(sel.config.fragment_mz_tolerance), np.float32(sel.config.precursor_mz_tolerance),
        batch["n_valid_fragments"], use_pallas=use_pallas, **static,
    )
    return {k: np.asarray(v) for k, v in out.items()}


def _port(sel) -> dict:
    batch, static, kernel, stride = _batch(sel)
    dev = sel.dia.device_arrays(stride, "cpu")
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = select_candidates_batch(
        dev["peak_store"], dev["cell_start"], t["frag_slot"], t["frag_mz"], t["iso_slot"], t["iso_mz"],
        t["cycle_start"], torch.from_numpy(kernel), sel.config.fragment_mz_tolerance,
        sel.config.precursor_mz_tolerance, t["n_valid_fragments"], **static,
    )
    return {k: v.numpy() for k, v in out.items()}


def _apex(out: dict, stride: int) -> int:
    """The fine cycle of the rank-0 candidate, as the drivers decode it."""
    assert out["valid"][0, 0] and out["rank"][0, 0] == 0
    return int(out["cycle_center"][0, 0]) * stride + stride // 2


def test_store_is_the_one_jax_builds(step0):
    sel, native, _ = step0
    assert build_peak_store_native is not None
    for name in STORE_ARRAYS:
        np.testing.assert_array_equal(getattr(sel.dia, name), getattr(native, name), err_msg=name)


def test_three_ways_agree_on_the_near_tie(step0, monkeypatch):
    sel, native, _ = step0
    xla = _jax(sel, native, use_pallas=False)
    monkeypatch.setattr(jax_selection, "extract_xic_pallas", functools.partial(extract_xic_pallas, interpret=True))
    pallas = _jax(sel, native, use_pallas=True)
    port = _port(sel)
    stride = _batch(sel)[3]
    assert stride == 2
    for who, out in (("pallas", pallas), ("port", port)):
        for k in ("valid", "rank", "cycle_center", "cycle_start", "cycle_stop"):
            np.testing.assert_array_equal(out[k], xla[k], err_msg=f"{who} {k}")
        np.testing.assert_allclose(out["score"], xla["score"], rtol=SCORE_TOL, atol=SCORE_TOL, err_msg=who)
    assert _apex(port, stride) == 461


def test_jax_builders_part_on_this_precursor(step0):
    sel, native, numpy_built = step0
    stride = _batch(sel)[3]
    assert _apex(_jax(sel, native, use_pallas=False), stride) == 461
    assert _apex(_jax(sel, numpy_built, use_pallas=False), stride) == 409
