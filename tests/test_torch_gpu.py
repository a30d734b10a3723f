"""The CUDA XIC kernel against its plain version, on the card, on random
queries, on the kernel's tiling (query counts that leave a block part
full, a block of masked queries only, a slab of exactly ``slab`` peaks, W
from 16 to 1024, Q of 1, 3 and 24), on the edges of ``torch_xic_edges``
and on the launches that a 4D scoring pass makes; the plain 4D
extraction rerun on the card, which must give the same bits; the
pipelined extraction against sequential selection and scoring, both
enqueuing every batch before they wait for any, classifier fits on the
card (one held to a fit on the CPU), the per-run workflow (load ->
optimization -> extraction), ``SearchStep`` (mzML and TSV library in,
``psm.parquet`` out; and from the committed Bruker ``.d`` and alphaRaw
``.hdf``) and the CLI on two runs (``alphadia-torch``, the
cross-run tables out) on the card, each held to the same run on the CPU.

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

from alphadia_torch.models.classifier import BinaryClassifier
from alphadia_torch.ops import scoring as ops_scoring
from alphadia_torch.ops import xic_cuda
from alphadia_torch.ops.xic import extract_xic_4d, extract_xic_packed
from alphadia_torch.rawdata import DiaData
from alphadia_torch.search.common import kernel_available
from alphadia_torch.search.pipelined import PipelinedExtraction
from alphadia_torch.search.scoring import FEATURE_COLUMNS, CandidateScoring, ScoringConfig
from alphadia_torch.search.selection import CandidateSelection, SelectionConfig
from alphadia_torch.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
from alphadia_torch.utils.device import batch_schedule
from torch_xic_edges import EDGE_CASES, W as EDGE_W, edge_inputs, edge_world_config

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
    cyc = dia.peak_cycle()[pick[:, 0]].astype(np.int64) // stride
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
    _, ref = _kernel_vs_plain((dev["peak_store"], dev["cell_start"], t(slot), t(qmz), 15.0, t(c0)), kw)
    assert float(ref[0].sum()) > 0


def _kernel_vs_plain(args, kw):
    """Kernel against plain on one launch, and a rerun bit-identical (no
    atomics); returns the kernel's planes and the plain version's."""
    before = xic_cuda.launches
    got = xic_cuda.extract_xic_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert xic_cuda.launches == before + 1
    ref = extract_xic_packed(*args, **kw)
    got = got if kw.get("with_mz") else (got,)
    ref = ref if kw.get("with_mz") else (ref,)
    for g, r, atol in zip(got, ref, (1e-3, 1e-6 if kw.get("mz_as_delta") else 1e-2)):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=atol)
    again = xic_cuda.extract_xic_cuda(*args, **kw)
    again = again if kw.get("with_mz") else (again,)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    return got, ref


TILING = {
    # name: (B, Q, W, with_mz, scan window); B * Q leaves the last block
    # part full for every W here but 512
    "w16_q1": (700, 1, 16, False, False),
    "w64_q3_scan": (517, 3, 64, True, True),
    "w64_q24": (101, 24, 64, True, False),
    "w512_q24": (31, 24, 512, False, False),
    "w1024_q3": (211, 3, 1024, True, False),
}


@pytest.mark.parametrize("case", sorted(TILING))
def test_kernel_tiling(card, case):
    """The first 256 queries are masked, so at least one block holds masked
    queries only; ``slab`` is the full length of the longest slab, so one
    query reads exactly ``slab`` peaks and the others are not clipped."""
    B, Q, W, with_mz, scan = TILING[case]
    dia = _world(with_mobility=scan)
    dev = dia.device_arrays(1, card)
    slot, qmz, c0 = _queries(dia, dev, B, Q, W, 1, sorted(TILING).index(case))
    slot.reshape(-1)[:256] = -1
    cs = dia.cell_start.reshape(dia.n_slots * dia.n_bins, -1)
    row = slot.astype(np.int64) * dia.n_bins + np.clip(
        np.floor((qmz - np.float32(dia.bin_mz_min)) / np.float32(dia.coarse_bin_width)), 0, dia.n_bins - 1
    ).astype(np.int64)
    lo = np.clip(c0, 0, dia.n_cycles)[:, None]
    hi = np.clip(c0.astype(np.int64) + W, 0, dia.n_cycles)[:, None]
    length = np.where(slot >= 0, cs[row, hi] - cs[row, lo], 0)
    slab = int(length.max())
    assert slab > 0 and (length == slab).sum() >= 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    kw = dict(
        n_cycles=dev["n_cycles"], n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min,
        bin_width=dia.coarse_bin_width, slab=slab, window_len=W, with_mz=with_mz,
        mz_as_delta=with_mz,
    )
    if scan:
        lo_s = np.random.default_rng(2).integers(0, 6, B).astype(np.int32)
        kw.update(scan_lo=t(lo_s), scan_hi=t(lo_s + 2))
    got, ref = _kernel_vs_plain((dev["peak_store"], dev["cell_start"], t(slot), t(qmz), 15.0, t(c0)), kw)
    assert float(ref[0].sum()) > 0
    for g in got:
        assert float(g.reshape(-1, W)[:256].abs().sum()) == 0.0


@pytest.mark.parametrize("case", EDGE_CASES)
def test_kernel_edge_cases(card, case):
    cfg, store = edge_world_config()
    spectra, _, _ = make_synthetic_dia(SyntheticConfig(**cfg))
    dia = DiaData.from_spectra(spectra, **store)
    stride = 2 if case == "stride2_view" else 1
    dev = dia.device_arrays(stride, card)
    slot, qmz, c0, extra, check = edge_inputs(dia, dev, case)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    def args_kw(**over):
        kw = dict(
            n_cycles=dev["n_cycles"], n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min,
            bin_width=dia.coarse_bin_width, window_len=EDGE_W, with_mz=True, mz_as_delta=True,
            cycle_stride=stride, **{**extra, **over},
        )
        if "scan_lo" in kw:
            kw.update(scan_lo=t(kw["scan_lo"]), scan_hi=t(kw["scan_hi"]))
        return (dev["peak_store"], dev["cell_start"], t(slot), t(qmz), 50.0, t(c0)), kw

    _kernel_vs_plain(*args_kw())
    check(lambda **over: xic_cuda.extract_xic_cuda(*args_kw(**over)[0], **args_kw(**over)[1])[0].cpu().numpy())


@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_cells_past_2_16_cycles(card, stride):
    """The cycle plane keeps each peak's cycle modulo 2**16: in a run of
    70,000 cycles, windows before, across and after cycle 65,536 (and past
    the last cycle) still put every peak into its own cell."""
    n_cycles, pad = 70_000, 1024
    rng = np.random.default_rng(4)
    cyc = np.sort(rng.choice(n_cycles, 4000, replace=False))  # one (slot, bin) row
    mz = np.concatenate([rng.uniform(500.0, 500.4, len(cyc)), np.full(pad, np.inf)]).astype(np.float32)
    inten = np.concatenate([rng.uniform(1.0, 100.0, len(cyc)), np.zeros(pad)]).astype(np.float32)
    cell_start = np.concatenate([[0], np.cumsum(np.bincount(cyc, minlength=n_cycles))]).astype(np.int32)
    dia = DiaData(
        cycle=np.full((1, 1, 1, 2), -1.0), rt_values=np.arange(n_cycles, dtype=np.float32),
        cycle_rt=np.arange(n_cycles, dtype=np.float32), n_cycles=n_cycles, n_slots=1, has_ms1=True,
        peak_mz=mz, peak_intensity=inten, peak_scanbin=np.zeros(len(mz), np.int32),
        cell_start=cell_start.reshape(1, 1, -1), n_bins=1, bin_mz_min=0.0, coarse_bin_width=1000.0,
    )
    dev = dia.device_arrays(stride, card)
    assert (cyc >= 1 << 16).any() and (dia.cycle_plane()[: len(cyc)] == cyc % (1 << 16)).all()
    W = 64
    c0 = np.array([100, 65_500, 65_536 - W // 2, 69_990, 131_000 // 2], np.int64) // stride
    B = len(c0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    args = (
        dev["peak_store"], dev["cell_start"], t(np.zeros((B, 2), np.int32)),
        t(np.full((B, 2), 500.2, np.float32)), 1000.0, t(c0.astype(np.int32)),
    )
    kw = dict(
        n_cycles=dev["n_cycles"], n_bins=1, bin_mz_min=0.0, bin_width=1000.0, window_len=W,
        with_mz=True, mz_as_delta=True, cycle_stride=stride,
    )
    _, ref = _kernel_vs_plain(args, kw)
    assert (ref[0][1:3].sum(dim=-1) > 0).all()  # the windows at 65,536 hold peaks


def test_wrapper_raises_on_bad_cuda_inputs(card):
    dia = _world()
    dev = dia.device_arrays(1, card)
    slot = torch.zeros((2, 3), dtype=torch.int32, device=card)
    qmz = torch.full((2, 3), 500.0, device=card)
    c0 = torch.zeros(2, dtype=torch.int32, device=card)
    kw = dict(n_cycles=dev["n_cycles"], n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min,
              bin_width=dia.coarse_bin_width, window_len=16)
    with pytest.raises(TypeError, match="int32"):
        xic_cuda.extract_xic_cuda(dev["peak_store"], dev["cell_start"], slot.long(), qmz, 10.0, c0, **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        xic_cuda.extract_xic_cuda(dev["peak_store"], dev["cell_start"], slot.cpu(), qmz, 10.0, c0, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        xic_cuda.extract_xic_cuda(dev["peak_store"], dev["cell_start"], slot.t().contiguous().t(), qmz, 10.0, c0, **kw)
    wide_scan = dev["peak_store"]._replace(scanbin=dev["peak_store"].scanbin.int())
    with pytest.raises(TypeError, match="store.scanbin"):
        xic_cuda.extract_xic_cuda(wide_scan, dev["cell_start"], slot, qmz, 10.0, c0, **kw)


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


def _library_world(with_mobility=False):
    spectra, prec, frag = make_synthetic_dia(
        SyntheticConfig(n_peptides=300, n_windows=6, n_cycles=350, with_mobility=with_mobility, seed=21)
    )
    prec, frag = add_synthetic_decoys(prec, frag)
    return spectra, DiaData.from_spectra(spectra, n_scan_bins=8), prec, frag


@pytest.mark.parametrize("with_mobility", [False, True], ids=["3d", "4d"])
def test_pipelined_equals_sequential_on_card(card, with_mobility):
    """The pipelined driver on the card gives the sequential drivers'
    candidates and PSMs (features within rtol 1e-5, atol 1e-6: the chunks
    differ, the arithmetic of a row does not)."""
    _, dia, prec, frag = _library_world(with_mobility)
    sel = SelectionConfig(candidate_count=3, batch_size=512)
    score = ScoringConfig(batch_size=256, collect_fragments=True)
    cands = CandidateSelection(dia, prec, frag, sel, device=card)()
    psm, _ = CandidateScoring(dia, prec, frag, score, device=card)(cands)
    before = xic_cuda.launches
    cands_p, psm_p, _ = PipelinedExtraction(dia, prec, frag, sel, score, sel_batch_cap=128, device=card)()
    assert xic_cuda.launches > before

    def rows(frame, keys):
        order = np.lexsort([frame[k] for k in reversed(keys)])
        return {k: v[order] for k, v in frame.items()}

    keys = ("precursor_idx", "rank", "frame_start", "frame_center", "frame_stop", "scan_start", "scan_stop")
    a, b = rows(cands, keys), rows(cands_p, keys)
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    a, b = rows(psm, ("precursor_idx", "rank")), rows(psm_p, ("precursor_idx", "rank"))
    assert len(a["precursor_idx"]) == len(b["precursor_idx"]) > 50
    np.testing.assert_array_equal(a["precursor_idx"], b["precursor_idx"])
    for f in FEATURE_COLUMNS:
        np.testing.assert_allclose(b[f], a[f], rtol=1e-5, atol=1e-6, err_msg=f)


def test_submit_enqueues_every_batch_before_any_wait(card):
    """``_submit`` and the scoring dispatch make no call that waits for the
    device (torch's sync debug mode raises on one: a copy to pageable
    memory, ``.item()``, ``nonzero``, a boolean-mask index), and leave one
    event per selection batch and scoring chunk. (The card's launch queue
    holds about a thousand kernels: a host that enqueues more than that
    ahead of the card blocks in the launch without any synchronisation.)
    The harvest then equals ``__call__``."""
    _, dia, prec, frag = _library_world()
    sel = CandidateSelection(dia, prec, frag, SelectionConfig(candidate_count=3, batch_size=256), device=card)
    score = CandidateScoring(dia, prec, frag, ScoringConfig(batch_size=256), device=card)
    expected = sel()  # also uploads the store and warms the pinned-memory cache
    psm_expected, _ = score(expected)
    dev = dia.device_arrays(1, card)
    geo = score._candidate_geometry(expected)
    n = len(expected["precursor_idx"])
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # the card stays busy while the host enqueues
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = sel._submit()
        lib, lib_dev = score._upload_lib()
        chunks = [
            score._dispatch_chunk(dev, lib_dev, score._geo_chunk(geo, b0, min(b0 + bsz, n)), geo["window_len"])
            for b0, bsz in batch_schedule(n, score._batch_cap())
        ]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    events = [p[1] for _, p in state["pending"]] + [p[1] for p in chunks]
    assert len(state["pending"]) == len(batch_schedule(len(prec["precursor_idx"]), 256)) > 1
    assert len(chunks) > 1 and all(isinstance(e, torch.cuda.Event) for e in events)
    got = [f for _, f in sel._harvest_iter(state)]
    for k in expected:
        np.testing.assert_array_equal(np.concatenate([f[k] for f in got]), expected[k], err_msg=k)
    psm, _ = score._harvest(chunks, expected, lib, geo)
    for f in FEATURE_COLUMNS:
        np.testing.assert_array_equal(psm[f], psm_expected[f], err_msg=f)


def test_classifier_fit_on_card(card):
    """A fit on the card: finite losses, and the fitted state on the CPU
    gives the card's probabilities within 1e-5."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(1.0, 1.0, (3000, 12)), rng.normal(0.0, 1.0, (3000, 12))]).astype(np.float32)
    y = np.concatenate([np.zeros(3000), np.ones(3000)]).astype(np.float32)
    clf = BinaryClassifier(random_state=0, epochs=3, device=card)
    clf.fit(x, y)
    assert clf.model.dense[0].weight.device.type == "cuda"
    assert len(clf.metrics["train_loss"]) == 3 and np.isfinite(clf.metrics["train_loss"]).all()
    on_cpu = BinaryClassifier.from_state_dict(clf.to_state_dict(), "cpu")
    np.testing.assert_allclose(clf.predict_proba(x), on_cpu.predict_proba(x), rtol=0, atol=1e-5)
    assert (clf.predict(x[:3000]) == 0).mean() > 0.7


def test_classifier_fit_on_card_matches_the_cpu(card):
    """A dropout-0 fit from one initial state and one ``random_state`` on
    the card and on the CPU (two epochs, 92 steps): parameters, BatchNorm
    running statistics and the epoch losses agree within the tolerances
    that hold the CPU fit to JAX's (atol 1e-4, rtol 1e-3;
    ``test_torch_classifier.test_training_matches_jax``)."""
    from alphadia_torch.convert import classifier_to_jax

    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(1.5, 1.0, (3000, 10)), rng.normal(0.0, 1.0, (3000, 10))]).astype(np.float32)
    y = np.concatenate([np.zeros(3000), np.ones(3000)]).astype(np.float32)
    fits = {}
    for dev in (card, "cpu"):
        clf = BinaryClassifier(random_state=0, epochs=2, dropout=0.0, device=dev)
        clf.fit(x, y)
        fits[dev if dev == "cpu" else "card"] = clf
    assert fits["card"].n_steps == fits["cpu"].n_steps == 2 * ((len(x) - 6) // 128)
    got, want = (classifier_to_jax(fits[d].model.state_dict()) for d in ("card", "cpu"))
    for group in ("params", "batch_stats"):
        for layer, arrays in want[group].items():
            for name, a in arrays.items():
                np.testing.assert_allclose(got[group][layer][name], a, rtol=1e-3, atol=1e-4, err_msg=f"{layer}/{name}")
    np.testing.assert_allclose(fits["card"].metrics["train_loss"], fits["cpu"].metrics["train_loss"], rtol=1e-3, atol=1e-4)


def test_workflow_on_card_matches_the_cpu(card, tmp_path):
    """The per-run workflow on the small 3D world of the CPU tests, on the
    card and on the CPU: the same steps per optimizer, the final tolerances
    within 5%, the target IDs at 1% FDR with a Jaccard overlap >= 0.95."""
    from torch_workflow_worlds import compare_runs, run_port

    on_card = run_port(tmp_path, "3d", "cuda")
    on_cpu = run_port(tmp_path, "3d", "cpu")
    assert on_card[0].device.type == "cuda"
    cmp = compare_runs(on_card[:2], on_cpu[:2])
    assert cmp["steps"][0] == cmp["steps"][1]
    assert cmp["tolerance_rel"] <= 0.05
    assert cmp["jaccard"] >= 0.95 and cmp["ids"][1] > 100


def test_search_step_on_card_matches_the_cpu(card, tmp_path):
    """``SearchStep`` from an mzML file and a TSV library on the small 3D
    world, on the card and on the CPU: the same steps per optimizer, the
    final tolerances within 5%, the target IDs at 1% FDR with a Jaccard
    overlap >= 0.95."""
    from torch_workflow_worlds import WORLDS, compare_runs, run_search_step, write_search_inputs

    raw_path, lib_path, _, _ = write_search_inputs(tmp_path, WORLDS["3d"]["world"])
    runs = {
        device: run_search_step(tmp_path / device, raw_path, lib_path, WORLDS["3d"]["config"], device)
        for device in ("cuda", "cpu")
    }
    assert runs["cuda"][1].device.type == "cuda"
    cmp = compare_runs(runs["cuda"][1:], runs["cpu"][1:])
    assert cmp["steps"][0] == cmp["steps"][1]
    assert cmp["tolerance_rel"] <= 0.05
    assert cmp["jaccard"] >= 0.95 and cmp["ids"][1] > 100


def test_search_from_the_fixture_d_on_card_matches_the_cpu(card, tmp_path):
    """``SearchStep`` from the committed Bruker ``.d`` (``alphadia_torch/
    testing/data/tdf_world.d``, frames compressed by real zstd) with a TSV
    library of its world's targets, on the card and on the CPU: the same
    steps per optimizer, the final tolerances within 5% (``WF_TOL_REL``),
    the target IDs at 1% FDR with a Jaccard overlap >= 0.95."""
    import json
    from pathlib import Path

    from alphadia_torch.testing.tsv_library import write_transition_list
    from torch_workflow_worlds import WORLDS, compare_runs, run_search_step

    data = Path(__file__).resolve().parents[1] / "alphadia_torch" / "testing" / "data"
    world = json.loads((data / "tdf_fixture.json").read_text())["world"]
    _, prec, frag = make_synthetic_dia(SyntheticConfig(**world))
    lib_path = tmp_path / "lib.tsv"
    write_transition_list(lib_path, prec, frag)
    runs = {
        device: run_search_step(tmp_path / device, data / "tdf_world.d", lib_path, WORLDS["4d"]["config"], device)
        for device in ("cuda", "cpu")
    }
    assert runs["cuda"][1].device.type == "cuda" and runs["cuda"][1].dia_data.has_mobility
    cmp = compare_runs(runs["cuda"][1:], runs["cpu"][1:])
    assert cmp["steps"][0] == cmp["steps"][1]
    assert cmp["tolerance_rel"] <= 0.05
    assert cmp["jaccard"] >= 0.95 and cmp["ids"][1] > 50


def test_search_from_the_fixture_hdf_on_card_matches_the_cpu(card, tmp_path):
    """The committed HDF fixture (``alphadia_torch/testing/data/hdf_*``,
    written by h5py) read by the port without h5py: every dataset's sha256
    and every attribute as h5py read them, each file written again by the
    port's writer and read back the same; then ``SearchStep`` from the
    alphaRaw ``.hdf`` with a TSV library of its world's targets, on the card
    and on the CPU: the same steps per optimizer, the final tolerances
    within 5%, the target IDs at 1% FDR with a Jaccard overlap >= 0.95."""
    import json

    from alphadia_torch.testing.tsv_library import write_transition_list
    from torch_hdf_fixture import DATA, FILES, file_record, rewritten
    from torch_workflow_worlds import WORLDS, compare_runs, run_search_step

    record = json.loads((DATA / "hdf_fixture.json").read_text())
    for name in FILES:
        assert file_record(DATA / name) == record["files"][name], name
        rewritten(DATA / name, tmp_path / name)
        assert file_record(tmp_path / name) == record["files"][name], name
    _, prec, frag = make_synthetic_dia(SyntheticConfig(**record["world_3d"]))
    lib_path = tmp_path / "lib.tsv"
    write_transition_list(lib_path, prec, frag)
    runs = {
        device: run_search_step(tmp_path / device, DATA / "hdf_alpharaw.hdf", lib_path, WORLDS["3d"]["config"], device)
        for device in ("cuda", "cpu")
    }
    assert runs["cuda"][1].device.type == "cuda"
    cmp = compare_runs(runs["cuda"][1:], runs["cpu"][1:])
    assert cmp["steps"][0] == cmp["steps"][1]
    assert cmp["tolerance_rel"] <= 0.05
    assert cmp["jaccard"] >= 0.95 and cmp["ids"][1] > 50


def test_cli_on_card_matches_the_cpu(card, tmp_path, monkeypatch):
    """``alphadia-torch`` on the two runs of the CLI end-to-end world
    (``tests/test_torch_cli.py``) on the card and on the CPU: exit 0 both,
    the 1%-FDR precursor IDs of each run with a Jaccard overlap >= 0.95."""
    import json

    from alphadia_torch.cli import run
    from alphadia_torch.utils.parquet import read_parquet
    from torch_workflow_worlds import E2E_OVERRIDES, E2E_WORLD, write_cli_inputs

    raws, lib, _, _ = write_cli_inputs(tmp_path, E2E_WORLD)
    ids = {}
    for device in ("cuda", "cpu"):
        monkeypatch.setenv("ALPHADIA_TORCH_DEVICE", device)
        out = tmp_path / device
        argv = ["-o", str(out), "-f", str(raws[0]), "-f", str(raws[1]), "-l", str(lib),
                "--config-dict", json.dumps(E2E_OVERRIDES)]
        try:
            run(argv)
        except SystemExit as e:
            assert e.code == 0, device
        psm = read_parquet(out / "precursors.parquet")
        keep = (psm["precursor.qval"] <= 0.01) & (psm["precursor.decoy"] == 0)
        ids[device] = {
            run_name: set(zip(psm["precursor.sequence"][keep & (psm["raw.name"] == run_name)],
                              psm["precursor.charge"][keep & (psm["raw.name"] == run_name)].tolist()))
            for run_name in ("run_0", "run_1")
        }
    for run_name in ("run_0", "run_1"):
        a, b = ids["cuda"][run_name], ids["cpu"][run_name]
        assert len(b) > 150
        assert len(a & b) / len(a | b) >= 0.95, run_name


@pytest.mark.parametrize("name", ["rt", "ms2", "ccs", "charge"])
def test_property_models_on_card_match_the_cpu(name):
    """Each property model with the packaged weights on the card against
    the same model on the CPU (TF32 off), atol 1e-4, on a digest of a seeded
    FASTA; needs the card only, not nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import tempfile
    from pathlib import Path

    from alphadia_torch.library.digest import digest_fasta
    from alphadia_torch.models.finetune import FinetuneManager
    from alphadia_torch.models.prediction import PACKAGED_MODELS
    from alphadia_torch.testing.fasta import write_fasta

    with tempfile.TemporaryDirectory() as tmp:
        df = digest_fasta([str(write_fasta(Path(tmp) / "db.fasta", 60, seed=4))]).precursor_df
    args = [list(df["sequence"]), list(df["mods"]), list(df["mod_sites"])]
    if name in ("ms2", "ccs"):
        args.append(df["charge"].astype(np.int32))
    method = {"rt": "predict_rt", "ms2": "predict_ms2", "ccs": "predict_mobility", "charge": "predict_charge"}[name]
    got = getattr(FinetuneManager.load(PACKAGED_MODELS, device="cuda"), method)(*args)
    want = getattr(FinetuneManager.load(PACKAGED_MODELS, device="cpu"), method)(*args)
    assert len(want) > FinetuneManager.PREDICT_BATCH  # a full batch and a padded tail
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _finetune_inputs(n=240, seed=11):
    """Seeded PSMs (two runs) and fragments as column dicts, numpy only:
    RT from hydrophobicity, charges from the basic residues, mobility from
    length and charge, b/y intensities along the backbone."""
    rng = np.random.default_rng(seed)
    aas = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    hydro = dict(zip(aas.tolist(), np.linspace(-1.0, 2.0, len(aas))))
    seqs = ["".join(rng.choice(aas, rng.integers(7, 22))) for _ in range(n)]
    rt = np.array([sum(hydro[a] for a in s) / len(s) for s in seqs])
    rt = (rt - rt.min()) / (rt.max() - rt.min())
    seq2 = seqs * 2
    z = np.array([2 + min(sum(a in "KRH" for a in s), 2) for s in seq2]) - (rng.random(2 * n) < 0.15)
    psm = {
        "run": np.repeat(np.array(["a", "b"], dtype=object), n), "precursor_idx": np.tile(np.arange(n), 2),
        "sequence": np.array(seq2, dtype=object), "mods": np.full(2 * n, "", dtype=object),
        "mod_sites": np.full(2 * n, "", dtype=object), "charge": z.astype(np.int64),
        "mod_seq_hash": np.tile(np.arange(n, dtype=np.uint64) * 7919 % 1000003, 2),
        "rt_norm": (np.tile(rt, 2) + rng.normal(0, 0.02, 2 * n)).astype(np.float32),
        "mobility_observed": (0.6 + 0.02 * np.array([len(s) for s in seq2]) / z).astype(np.float32),
    }
    rows = [(r, i, t, fz, pos, np.exp(-0.2 * abs(pos - len(s) / 2)) / fz + rng.random() * 0.1)
            for r, i, s in zip(psm["run"], psm["precursor_idx"], seq2)
            for pos in range(len(s) - 1) for t, fz in ((98, 1), (121, 1), (121, 2))]
    cols = list(zip(*rows))
    frag = {"run": np.array(cols[0], dtype=object), "precursor_idx": np.array(cols[1]), "type": np.array(cols[2]),
            "charge": np.array(cols[3]), "position": np.array(cols[4]), "intensity": np.array(cols[5], np.float32)}
    return psm, frag


@pytest.mark.parametrize("name", ["rt", "charge", "ms2", "ccs"])
def test_finetune_on_card_matches_the_cpu(name):
    """Each ``finetune_*`` on the card (TF32 off) against the same fit on
    the CPU, the same config and random state, 3 epochs of 3 steps: the
    split equal, the validation and test losses within rtol 1e-3, the
    metrics within rtol 1e-3, the predictions within atol 1e-3 (the two
    devices sum the convolution gradients in other orders, and Adam and an
    L1 loss spread that as between the JAX package and the port on the CPU:
    ``tests/test_torch_finetune.py``); needs the card only, not nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from alphadia_torch.models.finetune import FinetuneManager

    psm, frag = _finetune_inputs()
    out, split = {}, {}
    for dev in ("cuda", "cpu"):
        mgr = FinetuneManager({"epochs": 3, "batch_size": 112}, random_state=3, device=dev)
        s = mgr.trainer.split
        mgr.trainer.split = lambda n, rng, dev=dev, s=s: split.setdefault(dev, s(n, rng))
        metrics = getattr(mgr, f"finetune_{name}")(*((psm, frag) if name == "ms2" else (psm,)))
        args = [list(psm["sequence"]), list(psm["mods"]), list(psm["mod_sites"])]
        pred = {"rt": lambda: mgr.predict_rt(*args), "charge": lambda: mgr.predict_charge(*args),
                "ms2": lambda: mgr.predict_ms2(*args, psm["charge"]),
                "ccs": lambda: mgr.predict_mobility(*args, psm["charge"])}[name]()
        out[dev] = metrics, pred
    assert all(np.array_equal(a, b) for a, b in zip(split["cuda"], split["cpu"]))
    (mc, pc), (mh, ph) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(mc["history"], mh["history"], rtol=1e-3)
    np.testing.assert_allclose(np.array(mc["test_history"]), np.array(mh["test_history"]), rtol=1e-3)
    for k, v in mh.items():
        if not isinstance(v, list):
            np.testing.assert_allclose(mc[k], v, rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(pc, ph, atol=1e-3)
