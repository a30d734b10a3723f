"""The plain reference on its own (frozen copies only, no program): its
store of some slots is the whole store's rows of those slots, and it finds
the planted precursors."""

import subprocess
import sys

import numpy as np
import pytest

import tiny
from tiny import ROOT
from perfbench.bench import check
from perfbench.gen.world import make_world


@pytest.fixture(scope="module")
def world():
    return make_world(tiny.WORLD_3D, 123, "cpu")


def test_store_of_some_slots_is_the_whole_stores_rows(world):
    whole = check.reference_dia(world, np.arange(world.n_slots), 8, 1.0)
    slots = np.array([0, 2, 3])
    part = check.reference_dia(world, slots, 8, 1.0)
    assert part.n_bins == whole.n_bins and part.bin_mz_min == whole.bin_mz_min
    for j, s in enumerate(slots):
        cw, cp = whole.cell_start[s].astype(np.int64), part.cell_start[j].astype(np.int64)
        np.testing.assert_array_equal(cw - cw[0, 0], cp - cp[0, 0])
        a, b, c, d = cw[0, 0], cw[-1, -1], cp[0, 0], cp[-1, -1]
        np.testing.assert_array_equal(whole.peak_mz[a:b], part.peak_mz[c:d])
        np.testing.assert_array_equal(whole.peak_intensity[a:b], part.peak_intensity[c:d])


def test_reference_finds_the_planted_precursors(world):
    import json

    cfg = json.loads((ROOT / "alphadia_torch" / "config" / "default.json").read_text())
    om = {"rt_error": 20.0, "ms1_error": 5.0, "ms2_error": 10.0, "num_candidates": 3, "fwhm_rt": 5.0,
          "quad_sigma": (0.2, 0.2), "quad_delta_mu": (0.0, 0.0)}
    targets = np.flatnonzero(world.truth["detectable"])
    sample = check.Sample(slots=np.arange(world.n_slots), rows=targets,
                          rt=world.precursor["rt_library"][targets])
    dia = check.reference_dia(world, sample.slots, 8, 1.0)
    out = check.run_reference(world, dia, sample, cfg, om, "cpu")
    cand = out["cand"]
    best = cand["rank"] == 0
    apex = world.truth["apex_cycle"][cand["precursor_idx"][best].astype(np.int64)]
    near = np.abs(cand["frame_center"][best] - apex) <= 3
    assert near.sum() >= 0.9 * len(targets)
    assert len(out["psm"]["precursor_idx"]) >= len(targets)


def test_reference_imports_nothing_of_the_program():
    code = (
        f"import sys; sys.path.insert(0, {str(ROOT)!r}); import perfbench.bench.check, perfbench.gen.world;"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'alphadia_torch', 'alphadia_tpu', 'jax'}))"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _definition_xic(world, slots, query_mz, tol_ppm, c0, W):
    """XICs straight from the run's spectra: per cycle, the summed intensity
    of the slot's peaks within the ppm window (float64)."""
    tol = np.float32(tol_ppm) * np.float32(1e-6)
    q = query_mz.astype(np.float32)
    lo, hi = q * (np.float32(1) - tol), q * (np.float32(1) + tol)
    out = np.zeros(query_mz.shape + (W,))
    for b in range(query_mz.shape[0]):
        for j in range(query_mz.shape[1]):
            for w in range(W):
                c = c0[b] + w
                if not 0 <= c < world.n_cycles:
                    continue
                s = c * world.n_slots + slots[b, j]
                a, e = world.spec_start[s], world.spec_start[s + 1]
                mz = world.mz[a:e]
                keep = (mz >= lo[b, j]) & (mz <= hi[b, j])
                out[b, j, w] = world.intensity[a:e][keep].astype(np.float64).sum()
    return out


@pytest.fixture(scope="module")
def dense_queries(world):
    """Queries on every slot at the run's fragment and noise m/z, 40-cycle
    windows of a store whose rows hold far more than 4 peaks each."""
    rng = np.random.default_rng(5)
    B, Q, W = 24, 5, 40
    slots = rng.integers(0, world.n_slots, (B, Q))
    spec = rng.integers(0, world.n_cycles, (B, Q)) * world.n_slots + slots
    pick = world.spec_start[spec] + rng.integers(0, 20, (B, Q))
    return slots, world.mz[pick].astype(np.float32), rng.integers(-5, world.n_cycles - 30, B), W


def test_reference_xic_is_the_definition_whatever_the_slab(world, dense_queries, monkeypatch):
    """The reference reads every peak of a query's window: with a slab of 4
    peaks, and in blocks of a few queries, it gives the XICs of the spectra."""
    import torch

    from perfbench.reference import xic as ref_xic

    slots, qmz, c0, W = dense_queries
    dia = check.reference_dia(world, np.arange(world.n_slots), 8, 1.0)
    kw = dict(n_cycles=dia.n_cycles, n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min, bin_width=dia.coarse_bin_width,
              window_len=W, slab=4)
    args = (torch.from_numpy(dia.peak_mz), torch.from_numpy(dia.peak_intensity),
            torch.from_numpy(dia.cell_start.astype(np.int64)), torch.from_numpy(slots.astype(np.int32)),
            torch.from_numpy(qmz), 15.0, torch.from_numpy(c0.astype(np.int32)))
    want = _definition_xic(world, slots, qmz, 15.0, c0, W)
    assert (want > 0).sum() > 200
    widest = ref_xic._widest(dict(cell_start=args[2], slot_idx=args[3], query_mz=args[4], cycle_start=args[6], **kw))
    assert widest > 4 * 8  # the slab of 4 would cut most windows
    np.testing.assert_allclose(ref_xic.extract_xic(*args, **kw).numpy(), want, rtol=1e-5, atol=1e-3)
    monkeypatch.setattr(ref_xic, "_BLOCK_READS", widest * 5 * 3)  # blocks of 3 queries
    np.testing.assert_allclose(ref_xic.extract_xic(*args, **kw).numpy(), want, rtol=1e-5, atol=1e-3)


def test_reference_4d_xic_sums_to_the_definition(dense_queries):
    """In 4D the scan bins of a cell add up to the definition's XIC."""
    import torch

    from perfbench.reference import xic as ref_xic

    world4 = make_world(tiny.WORLD_4D, 321, "cpu")
    slots, _, c0, W = dense_queries
    rng = np.random.default_rng(6)
    slots = slots % world4.n_slots
    spec = rng.integers(0, world4.n_cycles, slots.shape) * world4.n_slots + slots
    qmz = world4.mz[world4.spec_start[spec] + rng.integers(0, 20, slots.shape)].astype(np.float32)
    dia = check.reference_dia(world4, np.arange(world4.n_slots), 8, 1.0)
    out = ref_xic.extract_xic_4d(
        torch.from_numpy(dia.peak_mz), torch.from_numpy(dia.peak_intensity),
        torch.from_numpy(dia.peak_scanbin.astype(np.int16)), torch.from_numpy(dia.cell_start.astype(np.int64)),
        torch.from_numpy(slots.astype(np.int32)), torch.from_numpy(qmz), 15.0, torch.from_numpy(c0.astype(np.int32)),
        n_cycles=dia.n_cycles, n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min, bin_width=dia.coarse_bin_width,
        n_scan_bins=dia.n_scan_bins, slab=4, window_len=W,
    )
    want = _definition_xic(world4, slots, qmz, 15.0, c0, W)
    np.testing.assert_allclose(out.sum(2).numpy(), want, rtol=1e-5, atol=1e-3)
