"""The port's XIC extraction against the Pallas kernel (interpret mode) for
the two views beside the plain one: (d) the coarse cycle view,
``cycle_stride`` 2, on the strided ``cell_start``, and (c) the per-candidate
scan-window crop on 4D data. Tolerances: rtol 1e-5, atol 1e-3 for
intensities and 1e-6 Da for the m/z plane as a delta.
"""

import numpy as np

from alphadia_torch.convert import diadata_from_jax
from alphadia_torch.ops.xic_cuda import extract_xic_cuda
from alphadia_tpu.rawdata import DiaData as JaxDiaData
from alphadia_tpu.testing.synthetic import SyntheticConfig, make_synthetic_dia
from test_torch_xic_pallas import compare, peak_queries, t

pytest_plugins = ("torch_port_plugin",)


def test_d_coarse_view_stride2():
    spectra, _, _ = make_synthetic_dia(
        SyntheticConfig(n_peptides=60, n_windows=6, n_cycles=90, noise_peaks_per_spectrum=40, seed=6)
    )
    jd = JaxDiaData.from_spectra(spectra, use_native=False)
    td = diadata_from_jax(jd)
    coarse = compare(jd, td, B=6, Q=9, W=24, slab=128, with_mz=False, stride=2, seed=3)
    # a coarse cell holds the sum of its two fine cycles
    fine_dev = td.device_arrays(1, "cpu")
    slot, qmz, c0 = peak_queries(td, 6, 9, 48, 3)
    c0 = (c0 // 2).astype(np.int32)
    fine = extract_xic_cuda(
        fine_dev["peak_store"], fine_dev["cell_start"], t(slot), t(qmz), 20.0, t(2 * c0),
        n_cycles=fine_dev["n_cycles"], n_bins=td.n_bins, bin_mz_min=td.bin_mz_min,
        bin_width=td.coarse_bin_width, slab=256, window_len=48,
    )
    np.testing.assert_allclose(
        coarse[0].numpy(), fine.reshape(6, 9, 24, 2).sum(-1).numpy(), rtol=1e-5, atol=1e-3
    )


def test_c_scan_window_crop():
    spectra, _, _ = make_synthetic_dia(
        SyntheticConfig(
            n_peptides=30, n_windows=4, n_cycles=50, noise_peaks_per_spectrum=30,
            with_mobility=True, seed=2,
        )
    )
    jd = JaxDiaData.from_spectra(spectra, n_scan_bins=8, use_native=False)
    td = diadata_from_jax(jd)

    def scan(B):
        rng = np.random.default_rng(5)
        lo = rng.integers(0, 4, B).astype(np.int32)
        return {"scan_lo": lo, "scan_hi": (lo + rng.integers(2, 5, B)).astype(np.int32)}

    compare(jd, td, B=5, Q=7, W=16, slab=128, with_mz=True, seed=4, scan=scan)
