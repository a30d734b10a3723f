"""The drivers' counters and the 4D extractions' spans (``utils/profiling``)
on the CPU, on tiny 3D and 4D worlds:

- ``scoring.cells`` and ``scoring.extent_cells``: each dispatched chunk's
  rows as dispatched (padding included) times its window bucket W, and
  each candidate's frames clipped to its chunk's W, against hand counts on
  the sequential scoring driver, the pipelined one and the one split over
  three devices;
- ``ops.xic_4d`` and ``ops.scan_profile``: one span a call of the wrappers
  (``ops/scan_cells_cuda``, which run the plain versions on the CPU), the
  same bits as untraced, and no device time on the CPU.
"""

import numpy as np
import pytest
import torch

from alphadia_torch.ops.scan_cells_cuda import extract_scan_profile_cuda, extract_xic_4d_cuda
from alphadia_torch.rawdata import DiaData
from alphadia_torch.search.pipelined import PipelinedExtraction
from alphadia_torch.search.scoring import CandidateScoring, ScoringConfig
from alphadia_torch.search.selection import CandidateSelection, SelectionConfig
from alphadia_torch.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
from alphadia_torch.utils import profiling

pytest_plugins = ("torch_port_plugin",)


@pytest.fixture(scope="module", params=["3d", "4d"])
def world(request):
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(
        n_peptides=40, n_windows=4, n_cycles=100, seed=11, with_mobility=request.param == "4d",
    ))
    prec, frag = add_synthetic_decoys(prec, frag)
    return DiaData.from_spectra(spectra, n_scan_bins=8), prec, frag


def _traced(fn):
    profiling.take()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.take()[1]


def _xic_kw(dia):
    dev = dia.device_arrays(1, torch.device("cpu"))
    return dev, dict(n_cycles=dev["n_cycles"], n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min,
                     bin_width=dia.coarse_bin_width, slab=16)


def test_scoring_cells_equal_a_hand_count(world):
    dia, prec, frag = world
    cand = CandidateSelection(dia, prec, frag, SelectionConfig(rt_tolerance=30.0), device="cpu")()
    scoring = CandidateScoring(dia, prec, frag, ScoringConfig(batch_size=32), device="cpu")
    (psm, _), counters = _traced(lambda: scoring(cand))
    n = len(cand["precursor_idx"])
    assert n > 32 and len(psm["precursor_idx"])
    # one window bucket over every candidate; one device, so no padding rows
    W = scoring._candidate_geometry(cand)["window_len"]
    extent = np.clip(cand["frame_stop"] - cand["frame_start"], 0, W)
    assert counters["scoring.cells"] == n * W
    assert counters["scoring.extent_cells"] == int(extent.sum())


def test_pipelined_scoring_cells_equal_a_hand_count(world, monkeypatch):
    dia, prec, frag = world
    chunks = []
    dispatch = CandidateScoring._dispatch

    def recording(self, devices, devs, lib_devs, geo, a, b, W):
        chunks.append((geo["frame_start"][a:b].copy(), geo["frame_stop"][a:b].copy(), W))
        return dispatch(self, devices, devs, lib_devs, geo, a, b, W)

    monkeypatch.setattr(CandidateScoring, "_dispatch", recording)
    pipe = PipelinedExtraction(dia, prec, frag, SelectionConfig(rt_tolerance=30.0, batch_size=16),
                               ScoringConfig(batch_size=32), device="cpu")
    (cand, _, _), counters = _traced(pipe)
    assert len(chunks) > 1 and sum(len(s) for s, _, _ in chunks) == len(cand["precursor_idx"])
    assert counters["scoring.cells"] == sum(len(s) * W for s, _, W in chunks)
    assert counters["scoring.extent_cells"] == sum(int(np.clip(e - s, 0, W).sum()) for s, e, W in chunks)


def test_sharded_scoring_counts_the_padded_rows(world, monkeypatch):
    """Split over three devices, each chunk is padded to a multiple of
    three rows: ``scoring.cells`` counts the rows as dispatched, the
    extent only the real candidates."""
    dia, prec, frag = world
    chunks = []
    dispatch = CandidateScoring._dispatch

    def recording(self, devices, devs, lib_devs, geo, a, b, W):
        chunks.append((len(devices), geo["frame_start"][a:b].copy(), geo["frame_stop"][a:b].copy(), W))
        return dispatch(self, devices, devs, lib_devs, geo, a, b, W)

    monkeypatch.setattr(CandidateScoring, "_dispatch", recording)
    cand = CandidateSelection(dia, prec, frag, SelectionConfig(rt_tolerance=30.0), device="cpu")()
    n = len(cand["precursor_idx"])
    cand = {k: v[: n - 1 if n % 3 == 0 else n] for k, v in cand.items()}  # some chunk is padded
    scoring = CandidateScoring(dia, prec, frag, ScoringConfig(batch_size=33, mesh_devices=3), devices=["cpu"] * 3)
    (psm, _), counters = _traced(lambda: scoring(cand))
    assert len(psm["precursor_idx"]) and {n for n, *_ in chunks} == {3}
    padded = [-(-len(s) // 3) * 3 for _, s, _, _ in chunks]
    assert sum(padded) > len(cand["precursor_idx"])
    assert counters["scoring.cells"] == sum(p * W for p, (*_, W) in zip(padded, chunks))
    assert counters["scoring.extent_cells"] == sum(int(np.clip(e - s, 0, W).sum()) for _, s, e, W in chunks)


@pytest.mark.parametrize("fn", ["xic_4d", "scan_profile"])
def test_plain_4d_extractions_are_spans_and_keep_their_bits(fn):
    """Under a profiler a 4D extraction's wrapper opens its span once and
    gives the bits it gives untraced; on the CPU it records no device time."""
    spectra, _, _ = make_synthetic_dia(SyntheticConfig(n_peptides=20, n_windows=2, n_cycles=60, seed=3,
                                                       with_mobility=True))
    dia = DiaData.from_spectra(spectra, n_scan_bins=8)
    dev, kw = _xic_kw(dia)
    rng = np.random.default_rng(7)
    B, Q, W = 12, 4, 16
    pick = rng.integers(0, dia.n_stored_peaks, (B, Q))
    row = np.searchsorted(dia.cell_start[:, :, 0].reshape(-1), pick, side="right") - 1
    slot = torch.from_numpy((row // dia.n_bins).astype(np.int32))
    qmz = torch.from_numpy(dia.peak_mz[pick].astype(np.float32))
    c0 = torch.from_numpy(rng.integers(0, dev["n_cycles"], B).astype(np.int32))
    head = (dev["peak_store"], dev["cell_start"], slot, qmz, 10.0, c0)

    def run():
        if fn == "xic_4d":
            return extract_xic_4d_cuda(*head, n_scan_bins=8, window_len=W, with_mz=True, **kw)
        return extract_scan_profile_cuda(*head, c0 + W, n_scan_bins=8, **kw)

    want = run()
    profiling.take()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = run()
    names = [ev.name() for ev in prof.profiler.kineto_results.events()]
    assert names.count(profiling.SPAN_PREFIX + "ops." + fn) == 1
    assert profiling.take() == ({}, {})
    planes = (lambda out: out) if fn == "xic_4d" else (lambda out: (out,))
    assert all(torch.equal(g, w) for g, w in zip(planes(got), planes(want), strict=True))
