#!/usr/bin/env python3
"""Where the XIC kernel's time goes on the main paths' launches, and a sweep
of its two tuned constants, on one CUDA card.

    python3 xic_sweep.py

Records every kernel launch of a warm-up run of the 3D and the 4D path (the
worlds and passes of ``chip_smoke.py``), then prints:

1. per launch, the kernel's warm and L2-flushed times (CUDA events, as in
   ``chip_smoke.py`` phase [5]); two floors, the kernel with every query
   masked and a plain write of its output planes; the shares of valid and
   live queries; the live slabs' length (mean, p99, clipped at ``slab``)
   and the 128-peak pieces they make. Per pass the sums, and the live part
   (kernel less the masked floor) per piece, all SMs together;
2. for each build of ``csrc/xic.cu`` with ``XIC_DEPTH`` (ring slots of a
   warp) and ``XIC_WARPS_PER_SM`` (warps a launch makes for each SM) set,
   the count of outputs outside the tolerance against the plain version on
   every launch, the warm time per pass, and the L2-flushed total.

Exits non-zero if the card is missing or a build disagrees with the plain
version.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

REPS = 20
# (XIC_DEPTH, XIC_WARPS_PER_SM); the first is the source's default
BUILDS = ((3, 128), (2, 128), (4, 128), (6, 128), (3, 32), (3, 64), (3, 256))


def launch_stats(cs, args, kw):
    """Valid and live shares, live slab lengths, clipped slabs and pieces."""
    _, _, _, length = cs.slabs(args, kw)
    _, _, _, full = cs.slabs(args, {**kw, "slab": 1 << 30})
    live = length > 0
    lens = length[live].float()
    return dict(
        valid=float((args[2] >= 0).float().mean()),
        live=float(live.float().mean()),
        mean=float(lens.mean()) if lens.numel() else 0.0,
        p99=float(lens.quantile(0.99)) if lens.numel() else 0.0,
        clipped=int((full > kw["slab"]).sum()),
        pieces=int(((length + cs.KERNEL_PIECE - 1) // cs.KERNEL_PIECE).sum()),
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("xic_sweep: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from alphadia_torch.ops import xic_cuda

    card = cs.card_line()
    cs.log(f"[sweep] {card}")
    xic_cuda.load()
    t0 = time.perf_counter()
    worlds = {
        "": cs.make_world(cs.N_PEPTIDES, cs.N_CYCLES),
        "_4d": cs.make_world(cs.N_PEPTIDES_4D, cs.N_CYCLES, with_mobility=True),
    }
    with cs.Recorder() as rec:
        for tag, world in worlds.items():
            cs.main_path(world, tag, rec=rec)
    torch.cuda.synchronize()
    calls = rec.calls
    cs.log(f"[sweep] {len(calls)} launches recorded in {time.perf_counter() - t0:.1f} s")
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    # ---- 1. where the time goes -------------------------------------------
    keys = ("ms", "flushed", "masked", "write", "pieces")
    per_pass = {}
    for stage, args, kw in calls:
        def kernel(a=args):
            return xic_cuda.extract_xic_cuda(*a, **kw)

        masked = (args[0], args[1], torch.full_like(args[2], -1), *args[3:])
        B, Q = args[2].shape
        out = torch.empty((2 if kw.get("with_mz") else 1) * B * Q * kw["window_len"], device="cuda")
        st = launch_stats(cs, args, kw)
        row = dict(
            ms=cs.device_ms(kernel, REPS),
            flushed=cs.device_ms_flushed(kernel, REPS, flush),
            masked=cs.device_ms(lambda: kernel(masked), REPS),
            write=cs.device_ms(out.zero_, REPS),
            pieces=st["pieces"],
        )
        cs.log(
            f"[launch] {stage:17s} {cs.variant(kw):13s} B={B} Q={Q} W={kw['window_len']} kernel {row['ms']:.4f} ms "
            f"(L2 flushed {row['flushed']:.4f}), all queries masked {row['masked']:.4f}, output write alone "
            f"{row['write']:.4f}; valid {st['valid']:.3f} live {st['live']:.3f}, live slab mean {st['mean']:.1f} "
            f"p99 {st['p99']:.0f} peaks, clipped {st['clipped']}, pieces {st['pieces']}"
        )
        acc = per_pass.setdefault(stage, dict.fromkeys(keys, 0))
        for k in keys:
            acc[k] += row[k]
    for stage, acc in per_pass.items():
        live_us = (acc["ms"] - acc["masked"]) * 1e3
        cs.log(
            f"[pass] {stage:17s} kernel {acc['ms']:.4f} ms (L2 flushed {acc['flushed']:.4f}), all queries masked "
            f"{acc['masked']:.4f}, output write alone {acc['write']:.4f}; live part {live_us:.1f} us over "
            f"{acc['pieces']} pieces, {live_us / max(acc['pieces'], 1) * 1e3:.3f} ns a piece on the whole card "
            f"({card})"
        )

    # ---- 2. the tuned constants --------------------------------------------
    bad_builds = []
    for depth, warps in BUILDS:
        defines = {"XIC_DEPTH": depth, "XIC_WARPS_PER_SM": warps}
        xic_cuda.build(verbose=True, defines=defines)
        xic_cuda.load(defines)
        bad = sum(r[2] for _, args, kw in calls for r in cs.compare(args, kw))
        warm, flushed = {}, 0.0
        for stage, args, kw in calls:
            def kernel(a=args):
                return xic_cuda.extract_xic_cuda(*a, **kw)

            warm[stage] = warm.get(stage, 0.0) + cs.device_ms(kernel, REPS)
            flushed += cs.device_ms_flushed(kernel, REPS, flush)
        cs.log(
            f"[build] XIC_DEPTH={depth} XIC_WARPS_PER_SM={warps}: outside_tol {bad}; warm ms "
            + " ".join(f"{s} {t:.4f}" for s, t in warm.items())
            + f" all {sum(warm.values()):.4f}; L2 flushed all {flushed:.4f} ({card})"
        )
        if bad:
            bad_builds.append(defines)
    xic_cuda.load()
    del flush
    if bad_builds:
        print(f"xic_sweep: builds disagree with the plain version: {bad_builds}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
