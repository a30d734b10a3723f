"""The wrappers of the scan-resolved kernel (``ops/scan_cells_cuda``) on CPU
tensors: ``extract_xic_4d_cuda`` and ``extract_scan_profile_cuda`` give the
plain versions' bits (``ops/xic.extract_xic_4d``, ``extract_scan_profile``)
for an int32 and an int64 cell index, fine and strided, and raise on every
argument the kernel would not take that can be checked without a card. The
kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

from alphadia_torch.ops import scan_cells_cuda
from alphadia_torch.ops.scan_cells_cuda import extract_scan_profile_cuda, extract_xic_4d_cuda
from alphadia_torch.ops.xic import extract_scan_profile, extract_xic_4d
from alphadia_torch.rawdata import DiaData
from alphadia_torch.testing.synthetic import SyntheticConfig, make_synthetic_dia

pytest_plugins = ("torch_port_plugin",)

B, Q, W = 9, 7, 24


@pytest.fixture(scope="module")
def dia():
    spectra, _, _ = make_synthetic_dia(
        SyntheticConfig(n_peptides=40, n_windows=3, n_cycles=80, seed=5, with_mobility=True)
    )
    return DiaData.from_spectra(spectra, n_scan_bins=8)


def _launch(dia, stride, index, seed=0):
    """(store, cell_start, slot, qmz, c0, c1, kw) on the CPU: queries on
    stored peaks, a masked row, windows that start before the run and end
    past it, profile windows of -3 to 20 cycles."""
    dev = dia.device_arrays(stride, "cpu")
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, dia.n_stored_peaks, (B, Q))
    row = np.searchsorted(dia.cell_start[:, :, 0].reshape(-1), pick, side="right") - 1
    slot = (row // dia.n_bins).astype(np.int32)
    slot[0] = -1
    slot[1, :3] = -1
    c0 = (dia.peak_cycle()[pick[:, 0]].astype(np.int64) // stride - rng.integers(0, W, B)).astype(np.int32)
    c0[2], c0[3] = -4, dev["n_cycles"] - 3
    c1 = c0 + rng.integers(-3, 20, B).astype(np.int32)
    kw = dict(n_cycles=dev["n_cycles"], n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min,
              bin_width=dia.coarse_bin_width, n_scan_bins=dia.n_scan_bins, slab=64)
    t = torch.from_numpy
    return (dev["peak_store"], dev["cell_start"].to(index), t(slot), t(dia.peak_mz[pick].astype(np.float32)),
            t(c0), t(c1), kw)


@pytest.mark.parametrize("stride", [1, 2], ids=["fine", "strided"])
@pytest.mark.parametrize("index", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("what", ["cells", "cells_mz", "profile"])
def test_wrappers_on_cpu_give_the_plain_bits(dia, what, index, stride):
    store, cs, slot, qmz, c0, c1, kw = _launch(dia, stride, index)
    head = (store.packed[:, 0], store.packed[:, 1], store.scanbin, cs, slot, qmz, 15.0)
    before = scan_cells_cuda.launches
    if what == "profile":
        got = (extract_scan_profile_cuda(store, cs, slot, qmz, 15.0, c0, c1, **kw),)
        want = (extract_scan_profile(*head, c0, c1, **kw),)
    else:
        mz = dict(window_len=W, with_mz=what == "cells_mz")
        got = extract_xic_4d_cuda(store, cs, slot, qmz, 15.0, c0, **kw, **mz)
        want = extract_xic_4d(*head, c0, **kw, **mz)
        got, want = (got, want) if mz["with_mz"] else ((got,), (want,))
    assert scan_cells_cuda.launches == before
    assert float(want[0].sum()) > 0
    assert all(torch.equal(g, w) for g, w in zip(got, want, strict=True))


def _bad(name):
    """``(function, args, kw)`` of a call with one argument the kernel does
    not take."""
    spectra, _, _ = make_synthetic_dia(SyntheticConfig(n_peptides=10, n_windows=2, n_cycles=30, seed=3,
                                                       with_mobility=True))
    store, cs, slot, qmz, c0, c1, kw = _launch(DiaData.from_spectra(spectra, n_scan_bins=8), 1, torch.int32)
    if name.startswith("profile_"):
        fn, cyc = extract_scan_profile_cuda, (c0, c1)
    else:
        fn, cyc, kw = extract_xic_4d_cuda, (c0,), dict(kw, window_len=W)
    changes = {
        "index_int16": dict(cs=cs.short()),
        "index_float": dict(cs=cs.float()),
        "index_array": dict(cs=cs.numpy()),
        "index_2d": dict(cs=cs.reshape(cs.shape[0], -1)),
        "index_short_rows": dict(cs=cs[:, :, :-2].contiguous()),
        "index_other_bins": dict(kw=dict(kw, n_bins=kw["n_bins"] + 1)),
        "no_scan_bins": dict(kw=dict(kw, n_scan_bins=0)),
        "no_cells": dict(kw=dict(kw, window_len=0)),
        "negative_slab": dict(kw=dict(kw, slab=-1)),
        "packed_float64": dict(store=store._replace(packed=store.packed.double())),
        "packed_three_columns": dict(store=store._replace(packed=torch.cat([store.packed, store.packed[:, :1]], 1))),
        "scanbin_int32": dict(store=store._replace(scanbin=store.scanbin.int())),
        "scanbin_short": dict(store=store._replace(scanbin=store.scanbin[:-1])),
        "store_on_meta": dict(store=store._replace(packed=store.packed.to("meta"))),
        "slot_int64": dict(slot=slot.long()),
        "slot_not_contiguous": dict(slot=slot.t().contiguous().t()),
        "slot_on_meta": dict(slot=slot.to("meta")),
        "query_float64": dict(qmz=qmz.double()),
        "query_other_shape": dict(qmz=qmz[:, :-1].contiguous()),
        "cycle_int64": dict(cyc=(c0.long(),)),
        "cycle_other_length": dict(cyc=(c0[:-1],)),
        "profile_stop_int64": dict(cyc=(c0, c1.long())),
        "profile_stop_other_length": dict(cyc=(c0, c1[:-1])),
        "profile_no_scan_bins": dict(kw=dict(kw, n_scan_bins=0)),
    }[name]
    store, cs, slot, qmz = (changes.get(k, v) for k, v in dict(store=store, cs=cs, slot=slot, qmz=qmz).items())
    return fn, (store, cs, slot, qmz, 15.0, *changes.get("cyc", cyc)), changes.get("kw", kw)


BAD = {
    "index_int16": (TypeError, "int32 or torch.int64"),
    "index_float": (TypeError, "int32 or torch.int64"),
    "index_array": (TypeError, "int32 or torch.int64"),
    "index_2d": (ValueError, "cell_start must have 3 dims"),
    "index_short_rows": (ValueError, "does not match"),
    "index_other_bins": (ValueError, "does not match"),
    "no_scan_bins": (ValueError, "n_scan_bins and window_len must be >= 1"),
    "no_cells": (ValueError, "n_scan_bins and window_len must be >= 1"),
    "negative_slab": (ValueError, "slab >= 0"),
    "packed_float64": (TypeError, "store.packed must be torch.float32"),
    "packed_three_columns": (ValueError, r"store.packed must be \[N, 2\]"),
    "scanbin_int32": (TypeError, "store.scanbin must be torch.int16"),
    "scanbin_short": (ValueError, r"store.scanbin \[N\]"),
    "store_on_meta": (ValueError, "unsupported device meta"),
    "slot_int64": (TypeError, "slot_idx must be torch.int32"),
    "slot_not_contiguous": (ValueError, "slot_idx must be contiguous"),
    "slot_on_meta": (ValueError, "slot_idx is on meta"),
    "query_float64": (TypeError, "query_mz must be torch.float32"),
    "query_other_shape": (ValueError, r"query_mz must be \[B, Q\]"),
    "cycle_int64": (TypeError, "cycle_start must be torch.int32"),
    "cycle_other_length": (ValueError, r"cycle_start must be \[B\]"),
    "profile_stop_int64": (TypeError, "cycle_hi must be torch.int32"),
    "profile_stop_other_length": (ValueError, r"cycle_hi must be \[B\]"),
    "profile_no_scan_bins": (ValueError, "n_scan_bins and window_len must be >= 1"),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_wrappers_raise_on_what_the_kernel_does_not_take(name):
    fn, args, kw = _bad(name)
    exc, match = BAD[name]
    before = scan_cells_cuda.launches
    with pytest.raises(exc, match=match):
        fn(*args, **kw)
    assert scan_cells_cuda.launches == before
