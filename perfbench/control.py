"""Readings of the check's numbers for the program and for the control.

    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up, a window of ``--seconds``,
then the check's extraction numbers of the program against the reference and
of the control (the reference one precision step down, in the program's
place) against the reference, on the run's sample. One JSON line a seed.
The limits in ``perfbench/checks`` lie between the two readings. This is
not part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seed: int, seconds: float, device=None, root=None) -> tuple[dict, dict]:
    """A run's set-up and window, then the check with the control: the
    program's numbers, and what they came from with the control's."""
    from perfbench.bench.cell import correctness, measure, prepare

    _, run = prepare(workload, seed, device, root)
    measure(run, seconds, False)
    return correctness(run, control=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.bench import env

    env.setup()
    for seed in args.seeds:
        t0 = time.perf_counter()
        prog, info = readings(args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "sampled": info["sampled precursors"],
                          "program": prog, "control": info["control"], "info": info,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
