"""The CUDA XIC kernel against its plain version, on the card, on random
queries and on the launches that a 4D scoring pass makes; and the plain 4D
extraction rerun on the card, which must give the same bits.

Marked ``gpu``: each test skips where no CUDA card is present, and the
decision is taken inside the test. On the card the file needs neither JAX
nor the JAX package, so it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances are the CPU tests': rtol 1e-5, atol 1e-3 for intensities, 1e-2
for absolute m/z and 1e-6 Da for the m/z plane as a delta from the query
centre. The kernel sums each cell directly in float32, the plain version
through float64 prefix sums.
"""

import numpy as np
import pytest
import torch

from alphadia_torch.ops import scoring as ops_scoring
from alphadia_torch.ops import xic_cuda
from alphadia_torch.ops.xic import extract_xic_4d, extract_xic_packed
from alphadia_torch.rawdata import DiaData
from alphadia_torch.search.common import kernel_available
from alphadia_torch.search.scoring import CandidateScoring, ScoringConfig
from alphadia_torch.search.selection import CandidateSelection, SelectionConfig
from alphadia_torch.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia

pytest_plugins = ("torch_port_plugin",)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    if not kernel_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _world(with_mobility=False, **kw):
    spectra, _, _ = make_synthetic_dia(
        SyntheticConfig(n_peptides=300, n_windows=6, n_cycles=200, with_mobility=with_mobility, seed=3, **kw)
    )
    return DiaData.from_spectra(spectra, n_scan_bins=8)


def _queries(dia, dev, B, Q, W, stride, seed):
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, dia.n_stored_peaks, (B, Q))
    row = np.searchsorted(dia.cell_start[:, :, 0].reshape(-1), pick, side="right") - 1
    slot = (row // dia.n_bins).astype(np.int32)
    slot[0, :2] = -1
    qmz = dia.peak_mz[pick].astype(np.float32)
    cyc = dia.packed_store()[pick[:, 0], 2].astype(np.int64) // stride
    c0 = (cyc - rng.integers(0, W, B)).astype(np.int32)
    c0[1] = -5
    c0[2] = dev["n_cycles"] - 2
    return slot, qmz, c0


CASES = {
    # name: (B, Q, W, slab, with_mz, mz_as_delta, stride, scan window)
    "a_intensity": (512, 24, 128, 256, False, False, 1, False),
    "a_slab_overflow": (256, 12, 64, 16, False, False, 1, False),
    "b_mz_delta": (512, 24, 32, 256, True, True, 1, False),
    "b_mz_absolute": (128, 24, 32, 256, True, False, 1, False),
    "c_scan_window": (256, 24, 32, 256, True, True, 1, True),
    "d_stride2": (512, 24, 128, 256, False, False, 2, False),
    "d_stride4": (128, 12, 64, 256, True, True, 4, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(card, case):
    B, Q, W, slab, with_mz, mz_as_delta, stride, scan = CASES[case]
    dia = _world(with_mobility=scan)
    dev = dia.device_arrays(stride, card)
    slot, qmz, c0 = _queries(dia, dev, B, Q, W, stride, sorted(CASES).index(case))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    kw = dict(
        n_cycles=dev["n_cycles"], n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min,
        bin_width=dia.coarse_bin_width, slab=slab, window_len=W, with_mz=with_mz,
        mz_as_delta=mz_as_delta, cycle_stride=stride,
    )
    if scan:
        rng = np.random.default_rng(1)
        lo = rng.integers(0, 6, B).astype(np.int32)
        kw.update(scan_lo=t(lo), scan_hi=t(lo + rng.integers(1, 4, B).astype(np.int32)))
    args = (dev["peak_packed"], dev["cell_start"], t(slot), t(qmz), 15.0, t(c0))
    before = xic_cuda.launches
    got = xic_cuda.extract_xic_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert xic_cuda.launches == before + 1
    ref = extract_xic_packed(*args, **kw)
    got = got if with_mz else (got,)
    ref = ref if with_mz else (ref,)
    for g, r, atol in zip(got, ref, (1e-3, 1e-6 if mz_as_delta else 1e-2)):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=atol)
    assert float(ref[0].sum()) > 0
    # repeated launches give bit-identical sums (no atomics)
    again = xic_cuda.extract_xic_cuda(*args, **kw)
    again = again if with_mz else (again,)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_wrapper_raises_on_bad_cuda_inputs(card):
    dia = _world()
    dev = dia.device_arrays(1, card)
    slot = torch.zeros((2, 3), dtype=torch.int32, device=card)
    qmz = torch.full((2, 3), 500.0, device=card)
    c0 = torch.zeros(2, dtype=torch.int32, device=card)
    kw = dict(n_cycles=dev["n_cycles"], n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min,
              bin_width=dia.coarse_bin_width, window_len=16)
    with pytest.raises(TypeError, match="int32"):
        xic_cuda.extract_xic_cuda(dev["peak_packed"], dev["cell_start"], slot.long(), qmz, 10.0, c0, **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        xic_cuda.extract_xic_cuda(dev["peak_packed"], dev["cell_start"], slot.cpu(), qmz, 10.0, c0, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        xic_cuda.extract_xic_cuda(dev["peak_packed"], dev["cell_start"], slot.t().contiguous().t(), qmz, 10.0, c0, **kw)


def test_4d_scoring_launches_match_plain(card, monkeypatch):
    """Variant (c), the scan-window crop, on the very launches of a 4D
    scoring pass: every launch carries a scan window and matches the plain
    version."""
    spectra, prec, frag = make_synthetic_dia(
        SyntheticConfig(n_peptides=300, n_windows=6, n_cycles=200, with_mobility=True, seed=3)
    )
    prec, frag = add_synthetic_decoys(prec, frag)
    dia = DiaData.from_spectra(spectra, n_scan_bins=8)
    cands = CandidateSelection(dia, prec, frag, SelectionConfig(candidate_count=3), device=card)()
    assert (cands["scan_stop"] > 1).any()
    calls = []

    def recording(*args, **kw):
        calls.append((args, kw))
        return xic_cuda.extract_xic_cuda(*args, **kw)

    monkeypatch.setattr(ops_scoring, "extract_xic_cuda", recording)
    before = xic_cuda.launches
    psm, _ = CandidateScoring(dia, prec, frag, ScoringConfig(batch_size=1024), device=card)(cands)
    torch.cuda.synchronize()
    assert len(psm["precursor_idx"]) > 100
    assert calls and xic_cuda.launches - before == len(calls)
    for args, kw in calls:
        assert kw["scan_lo"] is not None and kw["with_mz"] and kw["mz_as_delta"]
        got = xic_cuda.extract_xic_cuda(*args, **kw)
        ref = extract_xic_packed(*args, **kw)
        for g, r, atol in zip(got, ref, (1e-3, 1e-6)):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=atol)
    assert any(float(extract_xic_packed(*a, **k)[0].sum()) > 0 for a, k in calls)


def test_xic_4d_reruns_bit_identical(card):
    """The plain 4D extraction has no float scatter: a rerun on the card
    gives the same bits, and the CPU agrees."""
    dia = _world(with_mobility=True)
    dev = dia.device_arrays(1, card)
    slot, qmz, c0 = _queries(dia, dev, 512, 24, 64, 1, 0)

    def t(a, device=card):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    kw = dict(
        n_cycles=dev["n_cycles"], n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min,
        bin_width=dia.coarse_bin_width, n_scan_bins=dia.n_scan_bins, window_len=64, with_mz=True,
    )
    args = (dev["peak_mz"], dev["peak_intensity"], dev["peak_scanbin"], dev["cell_start"], t(slot), t(qmz), 15.0, t(c0))
    first = extract_xic_4d(*args, **kw)
    again = extract_xic_4d(*args, **kw)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert float(first[0].sum()) > 0
    cpu = dia.device_arrays(1, "cpu")
    on_cpu = extract_xic_4d(
        cpu["peak_mz"], cpu["peak_intensity"], cpu["peak_scanbin"], cpu["cell_start"],
        t(slot, "cpu"), t(qmz, "cpu"), 15.0, t(c0, "cpu"), **kw,
    )
    for a, b, atol in zip(first, on_cpu, (1e-4, 1e-8)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=atol)
