#!/usr/bin/env python3
"""Drive the PyTorch port's extraction path on one CUDA card.

    python3 chip_smoke.py              # full width
    python3 chip_smoke.py --profile    # also trace one pass of the main path

Phases, in order; any failure exits non-zero:

1. the card: name, count, and ``nvidia-smi`` name and power limit;
2. build the XIC kernel (``alphadia_torch/csrc/xic.cu``) with nvcc;
3. the kernel against its plain PyTorch version on the card, on the inputs
   that the main path hands it (recorded from a warm-up pass of the path)
   for variants (a) intensity only, (b) with the m/z plane as a delta, (d)
   the coarse view, and (c) the scan-window crop on a 4D world; and the
   path on the card against the same path on the CPU on a small world,
   scoring in float32 and in bfloat16;
4. the main path at full width: the synthetic DIA run of the JAX package's
   benchmark (6000 peptides + decoys = 12,000 precursors, 12 windows, 600
   cycles), candidate selection (rt_tolerance 60 s) -> scoring (bfloat16)
   -> a wide-window selection (450 s, coarsened to stride 2), with the
   kernel's launches counted per pass; then ``REPEATS`` more timed
   passes for the spread;
5. the kernel alone (CUDA events) on each recorded launch of the main path,
   beside the plain version and the least time the card needs for the
   bytes it must move;
6. the ``{"kernels": [...]}`` line, then the card's name and power limit,
   then the ``{"ok": true, ...}`` line last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the bench world's size, and the repetitions of the timings
N_PEPTIDES = 6000
N_CYCLES = 600
REPEATS = 5  # timed passes of the main path after the counted one
KERNEL_REPS = 20
PLAIN_REPS = 3
# kernel vs plain (rtol, atol): intensities; the m/z plane as absolute m/z;
# the m/z plane as a delta from the query centre, whose values lie within
# +-tol_ppm * m/z (~1e-2 Da), so its atol sits far below a typical delta
TOL_INTENSITY = (1e-5, 1e-3)
TOL_MZ_ABSOLUTE = (1e-5, 1e-2)
TOL_MZ_DELTA = (1e-5, 1e-6)
# share of detectable targets whose best candidate lies within 3 cycles of
# the true apex, and share of them with a PSM: the bench world reads 1.0
# for each, so these bounds allow a few in a thousand to move
TRUTH_SHARE_MIN = 0.995
PSM_SHARE_MIN = 0.995
# the path on the card against the path on the CPU, on a small world
CANDIDATE_MATCH_MIN = 0.99
FEATURE_REL_TOL = 1e-2
# bfloat16 scoring, card against CPU: the JAX package's bf16 tolerances
# (tests/unit/test_scoring_bf16.py) on each feature's median deviation
# relative to max(|value|, 1), the mass errors in ppm; and nine in ten
# values within FEATURE_REL_TOL, as the CPU tests hold the port to JAX
MASS_ERRORS = (
    "weighted_mass_deviation", "weighted_mass_error", "top_3_ms2_mass_error",
    "mean_ms2_mass_error", "mean_overlapping_mass_error",
)
BF16_TOL = dict(
    {k: 0.25 for k in MASS_ERRORS}, rt_observed=2e-3, mz_observed=1e-3,
    delta_frame_peak=0.05, base_width_rt=0.05, diff_b_y_ion_intensity=0.06,
)
BF16_TOL_DEFAULT = 0.02
DEVICE = "cuda"


def replaced_kernel(root: Path) -> str:
    """``file:line`` of the Pallas kernel that ``csrc/xic.cu`` replaces, read
    from the JAX package in this checkout (which the port never imports)."""
    for path in sorted(root.glob("*/ops/xic_pallas.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if line.startswith("def _xic_kernel("):
                return f"{path.relative_to(root)}:{i}"
    raise FileNotFoundError("the Pallas XIC kernel is not in this checkout")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# worlds and the main path
# ---------------------------------------------------------------------------
def make_world(n_peptides, n_cycles, seed=5, **kw):
    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.testing.synthetic import (
        SyntheticConfig,
        add_synthetic_decoys,
        make_synthetic_dia,
    )

    spectra, prec, frag = make_synthetic_dia(
        SyntheticConfig(
            n_peptides=n_peptides, n_windows=12, n_cycles=n_cycles,
            noise_peaks_per_spectrum=80, seed=seed, **kw,
        )
    )
    prec, frag = add_synthetic_decoys(prec, frag)
    return DiaData.from_spectra(spectra), prec, frag


def select(dia, prec, frag, device, rt_tolerance, batch_size=16384):
    from alphadia_torch.search.selection import CandidateSelection, SelectionConfig

    cfg = SelectionConfig(rt_tolerance=rt_tolerance, candidate_count=3, batch_size=batch_size)
    return CandidateSelection(dia, prec, frag, cfg, device=device)()


def score(dia, prec, frag, cands, device, compute_dtype, batch_size=8192):
    from alphadia_torch.search.scoring import CandidateScoring, ScoringConfig

    cfg = ScoringConfig(batch_size=batch_size, collect_fragments=True, compute_dtype=compute_dtype)
    return CandidateScoring(dia, prec, frag, cfg, device=device)(cands)


def main_path(dia, prec, frag, device=None):
    """The three passes of the main path, each timed on the host clock
    after a synchronise; returns (outputs, seconds, launches per pass)."""
    import torch

    from alphadia_torch.ops import xic_cuda

    device = device or DEVICE
    out, secs, launches = {}, {}, {}
    steps = (
        ("selection", lambda: select(dia, prec, frag, device, 60.0)),
        ("scoring", lambda: score(dia, prec, frag, out["selection"], device, "bfloat16")),
        ("selection_wide", lambda: select(dia, prec, frag, device, 450.0)),
    )
    for name, fn in steps:
        torch.cuda.synchronize()
        xic_cuda.launches = 0
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches[name] = xic_cuda.launches
    return out, secs, launches


class Recorder:
    """Wraps the kernel's wrapper where the path calls it, and keeps each
    call's arguments (the device tensors stay referenced)."""

    def __init__(self):
        import alphadia_torch.ops.scoring as ops_scoring
        import alphadia_torch.ops.selection as ops_selection

        self.modules = (ops_selection, ops_scoring)
        self.calls = []
        self.original = ops_selection.extract_xic_cuda

    def __enter__(self):
        def recording(*args, **kw):
            self.calls.append((self.stage, args, kw))
            return self.original(*args, **kw)

        self.stage = None
        for m in self.modules:
            m.extract_xic_cuda = recording
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.extract_xic_cuda = self.original


def variant(kw) -> str:
    if kw.get("scan_lo") is not None:
        return "c_scan_window"
    if kw.get("cycle_stride", 1) > 1:
        return "d_coarse"
    return "b_mz_delta" if kw.get("with_mz") else "a_intensity"


def truth_share(dia, prec, cands) -> float:
    """Share of detectable targets whose best candidate's frame_center lies
    within 3 cycles of the true apex (the generator's ``_truth_rt``)."""
    det = prec["_truth_detectable"] & (prec["decoy"] == 0)
    truth_cycle = np.abs(dia.cycle_rt[None, :] - prec["_truth_rt"][:, None]).argmin(1)
    best = cands["rank"] == 0
    where = {int(p): int(c) for p, c in zip(cands["precursor_idx"][best], cands["frame_center"][best])}
    idx = prec["precursor_idx"][det]
    hit = [abs(where.get(int(p), -10**6) - int(c)) <= 3 for p, c in zip(idx, truth_cycle[det])]
    return float(np.mean(hit)) if hit else 0.0


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------
def compare(args, kw):
    """Max abs and rel error and the count of elements outside the
    tolerance, per output plane, of the kernel against the plain version."""
    import torch

    from alphadia_torch.ops.xic import extract_xic_packed
    from alphadia_torch.ops.xic_cuda import extract_xic_cuda

    k = extract_xic_cuda(*args, **kw)
    torch.cuda.synchronize()
    p = extract_xic_packed(*args, **kw)
    torch.cuda.synchronize()
    k = k if isinstance(k, tuple) else (k,)
    p = p if isinstance(p, tuple) else (p,)
    tols = (TOL_INTENSITY, TOL_MZ_DELTA if kw.get("mz_as_delta") else TOL_MZ_ABSOLUTE)
    res = []
    for a, b, (rtol, atol) in zip(k, p, tols):
        err = (a - b).abs()
        bad = int((err > atol + rtol * b.abs()).sum())
        rel = float((err / b.abs().clamp(min=1e-6)).max())
        res.append((float(err.max()), rel, bad, float(b.abs().sum())))
    return res


def scan_window_inputs(device, B, Q, W, n_cycles=300):
    """Queries on the stored peaks of a 4D world, with random scan windows,
    at the scoring path's batch shape."""
    import torch

    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.testing.synthetic import SyntheticConfig, make_synthetic_dia

    spectra, _, _ = make_synthetic_dia(
        SyntheticConfig(n_peptides=600, n_windows=12, n_cycles=n_cycles, with_mobility=True, seed=7)
    )
    dia = DiaData.from_spectra(spectra, n_scan_bins=8)
    dev = dia.device_arrays(1, device)
    rng = np.random.default_rng(7)
    pick = rng.integers(0, dia.n_stored_peaks, (B, Q))
    row = np.searchsorted(dia.cell_start[:, :, 0].reshape(-1), pick, side="right") - 1
    slot = (row // dia.n_bins).astype(np.int32)
    qmz = dia.peak_mz[pick].astype(np.float32)
    cyc = dev["peak_packed"][torch.from_numpy(pick[:, 0]).to(device), 2].long().cpu().numpy()
    c0 = (cyc - rng.integers(0, W, B)).astype(np.int32)
    lo = rng.integers(0, 6, B).astype(np.int32)
    hi = (lo + rng.integers(1, 4, B)).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    args = (dev["peak_packed"], dev["cell_start"], t(slot), t(qmz), 15.0, t(c0))
    kw = dict(
        n_cycles=dev["n_cycles"], n_bins=dia.n_bins, bin_mz_min=dia.bin_mz_min,
        bin_width=dia.coarse_bin_width, slab=256, window_len=W, with_mz=True,
        mz_as_delta=True, scan_lo=t(lo), scan_hi=t(hi),
    )
    return args, kw


def small_world_agreement():
    """The path on the card against the same path on the CPU (plain
    version) on a small world: candidates, and the PSM features of float32
    and of bfloat16 scoring. Returns the candidate match, the candidate
    count, and per compute dtype the paired PSMs and their feature
    deviations relative to max(|value|, 1) (mass errors: absolute, ppm)."""
    from alphadia_torch.search.scoring import FEATURE_COLUMNS

    dia, prec, frag = make_world(300, 300, seed=11)
    out = {}
    for device in (DEVICE, "cpu"):
        dia.free_device()
        cands = select(dia, prec, frag, device, 60.0, batch_size=1024)
        psms = {dt: score(dia, prec, frag, cands, device, dt, batch_size=1024)[0] for dt in ("float32", "bfloat16")}
        out[device] = (cands, psms)
    dia.free_device()
    (cg, pg), (cc, pc) = out[DEVICE], out["cpu"]
    cols = ("precursor_idx", "rank", "frame_start", "frame_center", "frame_stop")

    def keys(c):
        return set(zip(*(c[k].tolist() for k in cols)))

    kg, kc = keys(cg), keys(cc)
    cand_match = len(kg & kc) / max(len(kg | kc), 1)
    devs = {}
    for dt in pg:
        g, c = pg[dt], pc[dt]
        ig = {k: i for i, k in enumerate(zip(g["precursor_idx"].tolist(), g["rank"].tolist()))}
        pairs = [(ig[k], i) for i, k in enumerate(zip(c["precursor_idx"].tolist(), c["rank"].tolist())) if k in ig]
        gi, ci = [p[0] for p in pairs], [p[1] for p in pairs]
        devs[dt] = len(pairs), len(c["precursor_idx"]), {
            f: np.abs(g[f][gi].astype(np.float64) - c[f][ci]) / (1.0 if f in MASS_ERRORS else np.maximum(np.abs(c[f][ci]), 1.0))
            for f in FEATURE_COLUMNS
        }
    return cand_match, len(kc), devs


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def device_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` over ``reps`` back-to-back runs. A sleep
    kernel keeps the card busy while the host enqueues them, so host
    overhead between launches does not count."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def work(args, kw):
    """(bytes, operations) that one launch must move and do on these
    inputs. Bytes: each input read once (the peaks that some query's slab
    covers; the cell offsets that some query reads; the query arrays) and
    each output plane written once. Queries of one slot and
    m/z bin share their peaks, which are counted once. A peak costs its
    m/z and intensity (8 B), and its scan bin (4 B more) under a scan
    window: the cells come from ``cell_start``, so its cycle is not part of
    the function's input. Operations: about eight float operations for
    each (query, slab peak) pair."""
    import torch

    from alphadia_torch.ops.xic import query_rows

    peak_packed, cell_start, slot, qmz, _, c0 = args
    B, Q = slot.shape
    W = kw["window_len"]
    n_cycles = kw["n_cycles"]
    L = cell_start.shape[2]
    row = query_rows(
        slot, qmz, n_slots=cell_start.shape[0], n_bins=kw["n_bins"],
        bin_mz_min=kw["bin_mz_min"], bin_width=kw["bin_width"],
    )
    lo = row * L + c0.long().clamp(0, n_cycles)[:, None]
    hi = row * L + (c0.long() + W).clamp(0, n_cycles)[:, None]
    flat = cell_start.reshape(-1)
    r0 = flat[lo].long()
    slab = torch.where(slot >= 0, (flat[hi].long() - r0).clamp(0, kw["slab"]), 0)
    # peaks covered by at least one slab: +1 at each start, -1 at each end
    edge = torch.zeros(peak_packed.shape[0] + 1, dtype=torch.int32, device=slot.device)
    live = slab > 0
    edge.index_add_(0, r0[live], torch.ones_like(r0[live], dtype=torch.int32))
    edge.index_add_(0, (r0 + slab)[live], -torch.ones_like(r0[live], dtype=torch.int32))
    unique_peaks = int((torch.cumsum(edge, 0)[:-1] > 0).sum())
    offsets = int(torch.unique(torch.cat([lo[slot >= 0], hi[slot >= 0]])).numel())
    planes = 2 if kw.get("with_mz") else 1
    nbytes = unique_peaks * 8 + offsets * 4 + B * Q * 8 + B * 4 + planes * B * Q * W * 4
    if kw.get("scan_lo") is not None:
        nbytes += unique_peaks * 4 + 2 * B * 4
    return nbytes, 8 * int(slab.sum())


def plain_peak_bytes(args, kw) -> int:
    """Device memory the plain version allocates beyond its inputs."""
    import torch

    from alphadia_torch.ops.xic import extract_xic_packed

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    extract_xic_packed(*args, **kw)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def profile_main_path(dia, prec, frag, out_dir: Path):
    """Trace one more pass of the main path with torch.profiler: device
    busy share, the XIC kernel's share, and the ops that take the device
    time (table written to ``out_dir/profile_main_path.txt``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        _, secs, _ = main_path(dia, prec, frag)
        wall = time.perf_counter() - t0
    # device-side events only: an aten op's own row repeats its kernels' time
    events = sorted(
        (e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")),
        key=dev_us, reverse=True,
    )
    busy = sum(dev_us(e) for e in events) * 1e-6
    xic = sum(dev_us(e) for e in events if "xic_kernel" in e.key) * 1e-6
    lines = [f"{dev_us(e) / 1e3:10.3f} ms {e.count:7d}x  {e.key[:110]}" for e in events[:40]]
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_main_path.txt").write_text("\n".join(lines) + "\n")
    log(
        f"[profile] traced pass: wall {wall:.4f} s (passes {json.dumps({k: round(v, 4) for k, v in secs.items()})}), "
        f"device busy {busy:.4f} s = {busy / wall:.3f} of wall, XIC kernel {xic * 1e3:.3f} ms"
    )
    for line in lines[:15]:
        log(f"[profile] {line}")


# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true", help="also trace one pass of the main path")
    opt = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "alphadia_torch" / "csrc" / "xic.cu").exists():
        print(f"chip_smoke: the alphadia_torch package is not beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from alphadia_torch.ops import xic_cuda

    # ---- 1. the card ------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"[1] device: {name} x{count}; nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = xic_cuda.build(verbose=True)
    log(f"[2] built {lib.relative_to(root)} in {time.perf_counter() - t0:.2f} s ({card})")

    # ---- world (set-up) ---------------------------------------------------
    t0 = time.perf_counter()
    dia, prec, frag = make_world(N_PEPTIDES, N_CYCLES)
    log(
        f"[world] {len(prec['precursor_idx'])} precursors, {len(frag['mz_library'])} fragments, "
        f"{dia.n_stored_peaks} stored peaks, {dia.n_cycles} cycles x {dia.n_slots} slots, "
        f"built in {time.perf_counter() - t0:.2f} s on the host"
    )

    # ---- 3. kernel vs plain on the card -----------------------------------
    t0 = time.perf_counter()
    with Recorder() as rec:
        rec.stage = "selection"
        cands = select(dia, prec, frag, DEVICE, 60.0)
        rec.stage = "scoring"
        score(dia, prec, frag, cands, DEVICE, "bfloat16")
        rec.stage = "selection_wide"
        select(dia, prec, frag, DEVICE, 450.0)
    torch.cuda.synchronize()
    log(f"[3] warm-up pass of the main path: {len(rec.calls)} kernel launches recorded in {time.perf_counter() - t0:.2f} s")

    worst = {}
    for stage, args, kw in rec.calls:
        res = compare(args, kw)
        v = variant(kw)
        B, Q = args[2].shape
        for plane, (mabs, mrel, bad, total) in zip(("intensity", "mz"), res):
            log(
                f"[3] {stage:14s} {v:12s} B={B} Q={Q} W={kw['window_len']} stride={kw.get('cycle_stride', 1)} "
                f"{plane:9s} max_abs={mabs:.3g} max_rel={mrel:.3g} outside_tol={bad} sum|plain|={total:.6g}"
            )
            if bad:
                raise AssertionError(f"kernel disagrees with the plain version: {stage} {v} {plane}")
            w = worst.setdefault(v, [0.0, 0.0])
            w[0], w[1] = max(w[0], mabs), max(w[1], mrel)
    first_scoring = next(c for c in rec.calls if c[0] == "scoring")
    B, Q = first_scoring[1][2].shape
    args_c, kw_c = scan_window_inputs(DEVICE, B, Q, first_scoring[2]["window_len"])
    for plane, (mabs, mrel, bad, total) in zip(("intensity", "mz"), compare(args_c, kw_c)):
        log(f"[3] 4d-world       c_scan_window B={B} Q={Q} {plane:9s} max_abs={mabs:.3g} max_rel={mrel:.3g} outside_tol={bad} sum|plain|={total:.6g}")
        if bad:
            raise AssertionError(f"kernel disagrees with the plain version: c_scan_window {plane}")
        w = worst.setdefault("c_scan_window", [0.0, 0.0])
        w[0], w[1] = max(w[0], mabs), max(w[1], mrel)
    for v in ("a_intensity", "b_mz_delta", "c_scan_window", "d_coarse"):
        if v not in worst:
            raise AssertionError(f"variant {v} was not checked")
        log(f"[3] variant {v}: max_abs_err={worst[v][0]:.3g} max_rel_err={worst[v][1]:.3g} ({card})")
    max_abs_err = max(w[0] for w in worst.values())

    cand_match, n_c, devs = small_world_agreement()
    log(f"[3] small world, card vs CPU: {cand_match:.4f} of {n_c} candidates identical (bound {CANDIDATE_MATCH_MIN})")
    if cand_match < CANDIDATE_MATCH_MIN:
        raise AssertionError("candidates on the card disagree with the plain path on the CPU")
    n_p, n_cpu, d = devs["float32"]
    feat_ok = float(np.mean(np.concatenate([v <= FEATURE_REL_TOL for v in d.values()])))
    log(
        f"[3] small world, float32 scoring: {n_p} of {n_cpu} PSMs paired, {feat_ok:.4f} of feature "
        f"values within {FEATURE_REL_TOL} (bound 0.99)"
    )
    if n_p < 0.99 * n_cpu or feat_ok < 0.99:
        raise AssertionError("float32 scoring on the card disagrees with the plain path on the CPU")
    n_p, n_cpu, d = devs["bfloat16"]
    med = {f: float(np.median(v)) for f, v in d.items()}
    q90 = {f: float(np.quantile(v, 0.9)) for f, v in d.items()}
    worst_f = max(med, key=lambda f: med[f] / BF16_TOL.get(f, BF16_TOL_DEFAULT))
    worst_q = max(q90, key=q90.get)
    worst_m = max(d, key=lambda f: d[f].max())
    log(
        f"[3] small world, bfloat16 scoring: {n_p} of {n_cpu} PSMs paired; largest median deviation against its "
        f"tolerance: {worst_f} {med[worst_f]:.3g} (tol {BF16_TOL.get(worst_f, BF16_TOL_DEFAULT)}); largest 90th "
        f"percentile: {worst_q} {q90[worst_q]:.3g} (tol {FEATURE_REL_TOL}); largest: {worst_m} {d[worst_m].max():.3g}"
    )
    bad = [f for f in d if med[f] > BF16_TOL.get(f, BF16_TOL_DEFAULT) or q90[f] > FEATURE_REL_TOL]
    if n_p < 0.99 * n_cpu or bad:
        raise AssertionError(f"bfloat16 scoring on the card disagrees with the plain path on the CPU: {bad}")

    # ---- 4. the main path -------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    out, secs, launches = main_path(dia, prec, frag)
    peak_mem = torch.cuda.max_memory_allocated()
    cands, (psm, frags), wide = out["selection"], out["scoring"], out["selection_wide"]
    n_prec = len(prec["precursor_idx"])
    from alphadia_torch.search.scoring import FEATURE_COLUMNS

    feats = np.stack([psm[f] for f in FEATURE_COLUMNS], 1)
    share = truth_share(dia, prec, cands)
    share_wide = truth_share(dia, prec, wide)
    total_s = secs["selection"] + secs["scoring"]
    log(f"[4] candidates {len(cands['precursor_idx'])}, PSMs {len(psm['precursor_idx'])}, fragments {len(frags['mz'])}, wide-window candidates {len(wide['precursor_idx'])}")
    log(f"[4] kernel launches per pass: {json.dumps(launches)}")
    log(f"[4] truth share (best candidate within 3 cycles of the apex): {share:.4f} (bound {TRUTH_SHARE_MIN}); wide window {share_wide:.4f} (bound {TRUTH_SHARE_MIN})")
    log(
        f"[4] wall s: selection {secs['selection']:.4f}, scoring {secs['scoring']:.4f}, "
        f"wide selection {secs['selection_wide']:.4f}; {n_prec / total_s:.1f} precursors/s "
        f"(selection+scoring); max_memory_allocated {peak_mem / 2**30:.3f} GiB ({name}, {card})"
    )
    if min(launches.values()) <= 0:
        raise AssertionError(f"a pass of the main path launched no kernel: {launches}")
    if feats.shape != (len(psm["precursor_idx"]), len(FEATURE_COLUMNS)) or not np.isfinite(feats).all():
        raise AssertionError("PSM features are not finite values of the expected shape")
    targets = prec["precursor_idx"][prec["_truth_detectable"] & (prec["decoy"] == 0)]
    psm_share = float(np.isin(targets, psm["precursor_idx"]).mean())
    log(f"[4] detectable targets with a PSM: {psm_share:.4f} (bound {PSM_SHARE_MIN})")
    if psm_share < PSM_SHARE_MIN:
        raise AssertionError("too few detectable targets were scored")
    if min(share, share_wide) < TRUTH_SHARE_MIN:
        raise AssertionError("candidates miss the true apexes")
    walls = [main_path(dia, prec, frag)[1] for _ in range(REPEATS)]
    rates = sorted(n_prec / (w["selection"] + w["scoring"]) for w in walls)
    for stage in secs:
        ms = sorted(w[stage] * 1e3 for w in walls)
        log(f"[4] {REPEATS} more passes, {stage} wall ms: median {np.median(ms):.2f}, min {ms[0]:.2f}, max {ms[-1]:.2f}")
    log(
        f"[4] {REPEATS} more passes, precursors/s (selection+scoring): median {np.median(rates):.1f}, "
        f"min {rates[0]:.1f}, max {rates[-1]:.1f} ({name}, {card})"
    )
    if opt.profile:
        profile_main_path(dia, prec, frag, root / "chiprun_out")

    # ---- 5. the kernel alone ----------------------------------------------
    from alphadia_torch.ops.xic import extract_xic_packed

    tot = dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0, plain_mem=0)
    per_stage = {}
    for stage, args, kw in rec.calls:
        k_ms = device_ms(lambda: xic_cuda.extract_xic_cuda(*args, **kw), KERNEL_REPS)
        p_ms = device_ms(lambda: extract_xic_packed(*args, **kw), PLAIN_REPS, warmup=1)
        p_mem = plain_peak_bytes(args, kw)
        nbytes, ops = work(args, kw)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        B, Q = args[2].shape
        log(
            f"[5] {stage:14s} {variant(kw):12s} B={B} Q={Q} W={kw['window_len']} kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms (peak {p_mem / 2**20:.1f} MiB), bound {bound:.4f} ms "
            f"({nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mop), {nbytes / k_ms / 1e6:.1f} GB/s"
        )
        for acc in (tot, per_stage.setdefault(stage, dict(tot, ms=0.0, plain_ms=0.0, bytes=0, ops=0, plain_mem=0))):
            acc["ms"] += k_ms
            acc["plain_ms"] += p_ms
            acc["bytes"] += nbytes
            acc["ops"] += ops
            acc["plain_mem"] = max(acc["plain_mem"], p_mem)
    for stage, acc in per_stage.items():
        log(
            f"[5] per pass {stage}: {launches[stage]} launches, kernel {acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms "
            f"(peak {acc['plain_mem'] / 2**20:.1f} MiB), bound {acc['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes), "
            f"wall of the pass {secs[stage] * 1e3:.2f} ms ({name}, {card})"
        )
    bound_ms = max(tot["bytes"] / HBM_BYTES_PER_S, tot["ops"] / FP32_OPS_PER_S) * 1e3
    bound_by = "bytes" if tot["bytes"] / HBM_BYTES_PER_S >= tot["ops"] / FP32_OPS_PER_S else "operations"

    # ---- 6. summary lines ---------------------------------------------------
    kernels = {
        "kernels": [
            {
                "name": "xic",
                "route": "cuda",
                "source": "alphadia_torch/csrc/xic.cu",
                "replaces": replaced_kernel(root),
                "launches": sum(launches.values()),
                "max_abs_err": max_abs_err,
                "ms": tot["ms"],
                "plain_ms": tot["plain_ms"],
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            }
        ]
    }
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
