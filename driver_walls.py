#!/usr/bin/env python3
"""One-device walls of the port's search drivers on one CUDA card, for a
comparison of two checkouts within one call.

    python3 driver_walls.py [--root DIR] [--repeats N]

Uses the package and the ``chip_smoke.py`` of the checkout at ``DIR``
(default: this script's own): the 3D and the 4D world of its phase [4],
then ``--repeats`` timed runs (after one warm-up run) of each of its
one-device passes: selection, scoring and the wide selection of phase [4]
(``main_path``), and the sequential and pipelined drivers of phase [6].
Each run is timed on the host clock between two synchronisations of the
card. Prints one line a pass (median, min and max wall ms) and, last, one
JSON object of every run's walls.

To compare a commit with its parent, unpack the parent into a directory
that ``.gitignore`` lists (``git archive``) and run parent, change, change,
parent in one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--repeats", type=int, default=5)
    opt = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("driver_walls: no CUDA device", file=sys.stderr)
        return 2
    root = opt.root.resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_of_root", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.rawdata import DiaData

    if not Path(xic_cuda.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"the package came from {xic_cuda.__file__}, not from {root}")
    xic_cuda.build()
    card = cs.card_line()
    walls = {}
    for tag, n_pep, kw in (("", cs.N_PEPTIDES, {}), ("_4d", cs.N_PEPTIDES_4D, {"with_mobility": True})):
        spectra, prec, frag = cs.make_spectra(n_pep, cs.N_CYCLES, **kw)
        world = DiaData.from_spectra(spectra, n_scan_bins=cs.N_SCAN_BINS), prec, frag

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for run in range(opt.repeats + 1):  # the first run warms up
            _, secs, _ = cs.main_path(world, tag)
            secs["sequential" + tag] = timed(lambda: cs.sequential(world))
            secs["pipelined" + tag] = timed(lambda: cs.pipelined(world))
            if run:
                for k, v in secs.items():
                    walls.setdefault(k, []).append(v * 1e3)
        world[0].free_device()
        del world, spectra
    for k, ms in walls.items():
        print(
            f"[walls] {root.name} {k}: median {np.median(ms):.2f} ms, min {min(ms):.2f}, max {max(ms):.2f} "
            f"({opt.repeats} runs; {card})",
            flush=True,
        )
    print(json.dumps({"root": str(root), "card": card, "walls_ms": walls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
