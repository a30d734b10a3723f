"""Run one cell of the benchmark of ``alphadia_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is the result (one JSON object); the last
lines of standard error are the check's numbers beside their limits. Without
a card it exits 2 and prints no result; with JAX or the JAX package loaded
after the window, 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.bench import env

    env.setup()
    from perfbench.bench.cell import Forbidden, NoDevice, run_cell

    try:
        result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    except NoDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except Forbidden as e:
        print(f"error: {e}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
