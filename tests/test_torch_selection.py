"""``select_candidates_batch`` of the port against the JAX function (its XLA
path, as it runs on the CPU) on the batch arrays that the selection driver
prepares from a synthetic world, at stride 1 and on the coarse view.

``valid``, ``rank`` and the cycle extents must be exactly equal; ``score``
agrees within float32 tolerance (the smoothing products and the per-query
sums run in another order). The score is standardized with the population
standard deviation (``jnp.std`` has ddof 0, ``torch.std`` defaults to 1),
which this comparison also pins: ddof 1 would move every score by
sqrt(W / (W - 1)).
"""

import numpy as np
import pytest
import torch

from alphadia_torch.convert import config_from_jax, diadata_from_jax, frame_from_pandas
from alphadia_torch.ops.selection import select_candidates_batch
from alphadia_torch.ops.smooth import gaussian_kernel_1d, rt_kernel_sigma
from alphadia_torch.search.selection import CandidateSelection
from alphadia_torch.utils.device import bucket_window
from alphadia_tpu.ops.selection import select_candidates_batch as jax_select
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.search.selection import SelectionConfig
from alphadia_tpu.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia

pytest_plugins = ("torch_port_plugin",)


@pytest.fixture(scope="module")
def world():
    spectra, prec, frag = make_synthetic_dia(
        SyntheticConfig(n_peptides=120, n_windows=6, n_cycles=300, seed=13)
    )
    prec, frag = add_synthetic_decoys(prec, frag)
    jd = JaxDiaData.from_spectra(spectra, use_native=False)
    return jd, diadata_from_jax(jd), frame_from_pandas(prec), frame_from_pandas(frag)


@pytest.mark.parametrize(
    "stride,join", [(1, True), (2, True), (1, False)], ids=["stride1", "stride2", "stride1_nojoin"]
)
def test_select_candidates_batch_matches(world, stride, join):
    jd, td, prec, frag = world
    cfg = config_from_jax(
        SelectionConfig(rt_tolerance=60.0, candidate_count=3, join_close_candidates=join)
    )
    arrays = CandidateSelection(td, prec, frag, cfg, device="cpu")._prepare_batch_arrays()
    dev = td.device_arrays(stride, "cpu")
    W = arrays["window_len"]
    c0 = arrays["cycle_start"]
    if stride > 1:
        W = bucket_window(max(-(-W // stride), 32, cfg.kernel_size))
        c0 = np.clip(c0 // stride, 0, dev["n_cycles"] - W).astype(np.int32)
    sigma = rt_kernel_sigma(cfg.fwhm_rt, cfg.sigma_scale_rt, td.cycle_time * stride)
    kernel = gaussian_kernel_1d(cfg.kernel_size, sigma)
    static = dict(
        n_cycles=dev["n_cycles"], n_bins=td.n_bins, bin_mz_min=td.bin_mz_min,
        bin_width=td.coarse_bin_width, slab=cfg.gather_slab, window_len=W,
        kernel_size=cfg.kernel_size, candidate_count=cfg.candidate_count,
        min_size_rt=max(1, cfg.min_size_rt // stride),
        max_size_rt=max(max(1, cfg.min_size_rt // stride) + 1, -(-cfg.max_size_rt // stride)),
        peak_cycle_tolerance=max(1, cfg.peak_cycle_tolerance // stride),
        join_close_candidates=join,
    )
    keys = ("frag_slot", "frag_mz", "iso_slot", "iso_mz")
    got = select_candidates_batch(
        dev["peak_store"], dev["cell_start"],
        *(torch.from_numpy(arrays[k]) for k in keys), torch.from_numpy(c0),
        torch.from_numpy(kernel), cfg.fragment_mz_tolerance, cfg.precursor_mz_tolerance,
        torch.from_numpy(arrays["n_valid_fragments"]), cycle_stride=stride, **static,
    )
    jdev = jd.device_arrays(stride)
    ref = jax_select(
        jdev["peak_mz"], jdev["peak_intensity"], jdev["peak_packed"], jdev["cell_start"],
        *(arrays[k] for k in keys), c0, kernel,
        np.float32(cfg.fragment_mz_tolerance), np.float32(cfg.precursor_mz_tolerance),
        arrays["n_valid_fragments"], use_pallas=False, cycle_stride=stride, **static,
    )
    valid = np.asarray(ref["valid"])
    assert valid.sum() > 0.5 * len(c0)
    for k in ("valid", "rank", "cycle_center", "cycle_start", "cycle_stop"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(ref["score"]), rtol=1e-4, atol=1e-5)

