"""The XIC kernel on each device's shard (``parallel/shard_ops``), on the CPU.

- Over 2 and 8 ``"cpu"`` devices the sharded route equals the unsharded
  extraction exactly (each query is independent), in the kernel's four
  variants: (a) intensity, (b) with the m/z plane as a delta, (c) the scan
  window of 4D scoring, (d) the coarse (strided) view;
- it equals the JAX package's ``extract_xic_pallas_sharded`` (``shard_map``
  of the Pallas kernel over the suite's virtual 8-device CPU mesh, in
  interpret mode as JAX's ``tests/unit/test_shard_ops.py`` runs it) at rtol
  1e-5, atol 1e-2 (one compile);
- a batch that does not split evenly, or a store missing for a device,
  raises.
"""

import jax
import numpy as np
import pytest
import torch

from alphadia_torch.convert import diadata_from_jax
from alphadia_torch.ops.xic_cuda import extract_xic_cuda
from alphadia_torch.parallel.mesh import make_mesh
from alphadia_torch.parallel.shard_ops import extract_xic_cuda_sharded
from alphadia_torch.rawdata import DiaData
from alphadia_torch.testing.synthetic import SyntheticConfig, make_synthetic_dia
from alphadia_tpu.parallel.mesh import make_mesh as jax_make_mesh
from alphadia_tpu.parallel.shard_ops import extract_xic_pallas_sharded
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.testing.synthetic import SyntheticConfig as JaxSyntheticConfig
from alphadia_tpu.testing.synthetic import make_synthetic_dia as jax_make_synthetic_dia

pytest_plugins = ("torch_port_plugin",)

B, Q, W = 16, 6, 32


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for tag, mob in (("3d", False), ("4d", True)):
        spectra, _, _ = make_synthetic_dia(SyntheticConfig(n_peptides=80, n_windows=4, n_cycles=96, seed=13,
                                                           with_mobility=mob))
        out[tag] = DiaData.from_spectra(spectra, n_scan_bins=8) if mob else DiaData.from_spectra(spectra)
    return out


def queries(dia, stride, seed=0):
    """Queries centred on stored peaks, some masked, windows at the edges."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, dia.n_stored_peaks, (B, Q))
    row = np.searchsorted(dia.cell_start[:, :, 0].reshape(-1), pick, side="right") - 1
    slot = (row // dia.n_bins).astype(np.int32)
    slot[0, -2:] = -1
    qmz = (dia.peak_mz[pick] * (1 + rng.normal(0, 3e-6, (B, Q)))).astype(np.float32)
    c0 = ((dia.peak_cycle()[pick[:, 0]].astype(np.int64) - rng.integers(0, W * stride, B)) // stride).astype(np.int32)
    c0[0] = -3
    return torch.from_numpy(slot), torch.from_numpy(qmz), torch.from_numpy(c0)


VARIANTS = {
    "a_intensity": dict(tag="3d", stride=1, with_mz=False),
    "b_mz_delta": dict(tag="3d", stride=1, with_mz=True),
    "c_scan_window": dict(tag="4d", stride=1, with_mz=True),
    "d_coarse": dict(tag="3d", stride=2, with_mz=False),
}


@pytest.mark.parametrize("n_devices", [2, 8])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sharded_route_equals_the_unsharded_extraction(worlds, variant, n_devices):
    v = VARIANTS[variant]
    dia = worlds[v["tag"]]
    dev = dia.device_arrays(v["stride"], "cpu")
    slot, qmz, c0 = queries(dia, v["stride"])
    kw = dict(
        n_cycles=dev["n_cycles"], n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min, bin_width=dia.coarse_bin_width,
        slab=64, window_len=W, with_mz=v["with_mz"], mz_as_delta=v["with_mz"], cycle_stride=v["stride"],
    )
    if v["tag"] == "4d":
        lo = torch.from_numpy(np.random.default_rng(1).integers(0, 5, B).astype(np.int32))
        kw.update(scan_lo=lo, scan_hi=lo + 3)
    want = extract_xic_cuda(dev["peak_store"], dev["cell_start"], slot, qmz, 15.0, c0, **kw)
    devices = make_mesh(devices=["cpu"] * n_devices)
    got = extract_xic_cuda_sharded(
        devices, [dev["peak_store"]] * n_devices, [dev["cell_start"]] * n_devices, slot, qmz, 15.0, c0, **kw
    )
    want, got = (want, got) if v["with_mz"] else ((want,), (got,))
    for w, g in zip(want, got):
        assert g.shape == (B, Q, W) and g.device == devices[0]
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert float(want[0].sum()) > 0


def test_sharded_route_matches_jax_shard_map():
    assert len(jax.devices()) == 8
    spectra, _, _ = jax_make_synthetic_dia(JaxSyntheticConfig(n_peptides=60, n_windows=4, n_cycles=64, seed=13))
    jd = JaxDiaData.from_spectra(spectra)
    td = diadata_from_jax(jd)
    jdev, tdev = jd.device_arrays(), td.device_arrays(1, "cpu")
    slot, qmz, c0 = queries(td, 1, seed=3)
    kw = dict(n_cycles=td.n_cycles, n_bins=td.n_bins, bin_mz_min=td.bin_mz_min, bin_width=td.coarse_bin_width,
              slab=256, window_len=W)
    theirs = np.asarray(extract_xic_pallas_sharded(
        jax_make_mesh(8), jdev["peak_packed"], jdev["cell_start"], slot.numpy(), qmz.numpy(), np.float32(10.0),
        c0.numpy(), interpret=True, **kw,
    ))
    ours = extract_xic_cuda_sharded(["cpu"] * 8, [tdev["peak_store"]] * 8, [tdev["cell_start"]] * 8,
                                    slot, qmz, 10.0, c0, **kw).numpy()
    assert ours.shape == theirs.shape == (B, Q, W)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-2)
    assert theirs.sum() > 0


def test_uneven_batches_and_missing_stores_raise(worlds):
    dia = worlds["3d"]
    dev = dia.device_arrays(1, "cpu")
    slot, qmz, c0 = queries(dia, 1)
    kw = dict(n_cycles=dev["n_cycles"], n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min,
              bin_width=dia.coarse_bin_width, window_len=W)
    with pytest.raises(ValueError, match="equal shards"):
        extract_xic_cuda_sharded(["cpu"] * 3, [dev["peak_store"]] * 3, [dev["cell_start"]] * 3, slot, qmz, 15.0, c0, **kw)
    with pytest.raises(ValueError, match="one store"):
        extract_xic_cuda_sharded(["cpu"] * 2, [dev["peak_store"]], [dev["cell_start"]] * 2, slot, qmz, 15.0, c0, **kw)
