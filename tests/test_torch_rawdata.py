"""The port's synthetic world and peak store equal the JAX package's."""

import numpy as np
import pytest
import torch

from alphadia_torch.rawdata import DiaData
from alphadia_torch.testing.synthetic import (
    SyntheticConfig,
    add_synthetic_decoys,
    make_synthetic_dia,
)
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.testing import synthetic as jax_synthetic

pytest_plugins = ("torch_port_plugin",)

_SPECTRA_FIELDS = (
    "rt", "ms_level", "isolation_lower_mz", "isolation_upper_mz",
    "peak_start_idx", "peak_stop_idx", "mz", "intensity", "mobility",
)


def _worlds(seed, **kw):
    cfg = dict(n_peptides=40, n_windows=4, n_cycles=60, noise_peaks_per_spectrum=20, seed=seed, **kw)
    ours = make_synthetic_dia(SyntheticConfig(**cfg))
    theirs = jax_synthetic.make_synthetic_dia(jax_synthetic.SyntheticConfig(**cfg))
    return ours, theirs


def _assert_frame_equal(ours: dict, theirs):
    # the port drops the xxhash columns, which nothing on the path reads
    expected = [c for c in theirs.columns if c not in ("mod_seq_hash", "mod_seq_charge_hash")]
    assert sorted(ours) == sorted(expected)
    for c in expected:
        a, b = ours[c], theirs[c].to_numpy()
        if b.dtype == object:
            assert [str(x) for x in a] == [str(x) for x in b], c
        else:
            assert a.dtype == b.dtype, (c, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=c)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("with_mobility", [False, True])
def test_synthetic_world_is_identical(seed, with_mobility):
    (sp, prec, frag), (jsp, jprec, jfrag) = _worlds(seed, with_mobility=with_mobility)
    for f in _SPECTRA_FIELDS:
        a, b = getattr(sp, f), getattr(jsp, f)
        if b is None:
            assert a is None, f
        else:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    _assert_frame_equal(prec, jprec)
    _assert_frame_equal(frag, jfrag)


@pytest.mark.parametrize("seed", [0, 7])
def test_decoys_are_identical(seed):
    (_, prec, frag), (_, jprec, jfrag) = _worlds(seed)
    for multiplier in (1, 2):
        p, f = add_synthetic_decoys(prec, frag, multiplier=multiplier)
        jp, jf = jax_synthetic.add_synthetic_decoys(jprec, jfrag, multiplier=multiplier)
        _assert_frame_equal(p, jp)
        _assert_frame_equal(f, jf)


@pytest.fixture(scope="module", params=[False, True], ids=["3d", "4d"])
def stores(request):
    (sp, _, _), _ = _worlds(3, with_mobility=request.param)
    return DiaData.from_spectra(sp), JaxDiaData.from_spectra(sp, use_native=False)


_DIA_ARRAYS = (
    "cycle", "rt_values", "cycle_rt", "peak_mz", "peak_intensity", "cell_start",
    "peak_is_ghost", "peak_scanbin", "mobility_values",
)
_DIA_SCALARS = (
    "n_cycles", "n_slots", "has_ms1", "has_mobility", "n_scan_bins", "n_bins",
    "bin_mz_min", "coarse_bin_width", "mz_min", "mz_max", "quad_min_mz",
    "quad_max_mz", "n_peaks", "n_stored_peaks", "n_cycles_dev", "cycle_time",
)


def test_diadata_host_arrays_equal(stores):
    ours, theirs = stores
    for name in _DIA_ARRAYS:
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name), err_msg=name)
    for name in _DIA_SCALARS:
        assert getattr(ours, name) == getattr(theirs, name), name


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_device_arrays_equal(stores, stride):
    ours, theirs = stores
    d = ours.device_arrays(stride, "cpu")
    j = {k: np.asarray(v) for k, v in theirs.device_arrays(stride).items()}
    assert d["n_cycles"] == int(j["n_cycles"])
    np.testing.assert_array_equal(d["cell_start"].numpy(), j["cell_start"])
    np.testing.assert_array_equal(d["cycle_rt"].numpy(), j["cycle_rt"])
    # the JAX store is [NR, 4, 128] lane rows; the port's is one row per peak
    jp = j["peak_packed"].transpose(0, 2, 1).reshape(-1, 4)
    packed = d["peak_packed"].numpy()
    assert packed.shape[0] == len(j["peak_mz"])
    np.testing.assert_array_equal(packed, jp[: packed.shape[0]])
    np.testing.assert_array_equal(d["peak_mz"].numpy(), j["peak_mz"])
    np.testing.assert_array_equal(d["peak_intensity"].numpy(), j["peak_intensity"])
    np.testing.assert_array_equal(d["peak_scanbin"].numpy(), j["peak_scanbin"])
    assert d["peak_packed"].dtype == torch.float32 and d["peak_packed"].is_contiguous()
    # the coarse view shares the fine view's peak store
    assert d["peak_packed"] is ours.device_arrays(1, "cpu")["peak_packed"]


def test_convert_carries_the_jax_state(stores):
    from alphadia_torch.convert import diadata_from_jax

    ours, theirs = stores
    conv = diadata_from_jax(theirs)
    for name in _DIA_ARRAYS:
        np.testing.assert_array_equal(getattr(conv, name), getattr(ours, name), err_msg=name)
    for name in _DIA_SCALARS:
        assert getattr(conv, name) == getattr(ours, name), name


def test_dia_cycle_matches():
    from alphadia_torch.rawdata import determine_dia_cycle
    from alphadia_tpu.rawdata import determine_dia_cycle as jax_cycle

    (sp, _, _), _ = _worlds(1)
    a = determine_dia_cycle(sp.rt, sp.isolation_lower_mz, sp.isolation_upper_mz)
    b = jax_cycle(sp.rt, sp.isolation_lower_mz, sp.isolation_upper_mz)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]


@pytest.mark.parametrize(
    "n,cap", [(1, 16384), (255, 256), (5000, 4096), (12000, 16384), (37000, 8192)]
)
def test_batch_helpers_match(n, cap):
    from alphadia_torch.utils import device as ours
    from alphadia_tpu.utils import device as theirs

    assert ours.batch_schedule(n, cap) == theirs.batch_schedule(n, cap)
    assert ours.effective_batch(cap, n) == theirs.effective_batch(cap, n)
    assert ours.bucket_window(n) == theirs.bucket_window(n)
    assert ours.bucket_count(n) == theirs.bucket_count(n)
