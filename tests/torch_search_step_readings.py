"""The port's ``SearchStep`` on a world made from sequences, at several
random states: the spread of what ``chip_smoke.py`` phase [8] gates (the
identified and false shares at 1% FDR, the final RT tolerance). No JAX, so
it runs on the card as well as on the CPU. Usage:

    PYTHONPATH=. python3 tests/torch_search_step_readings.py --peptides 6000 --windows 12 --random-states 0,1,2
    PYTHONPATH=. python3 tests/torch_search_step_readings.py --peptides 25000 --windows 12 --mobility --random-states 0,1,2

With ``--bruker`` it runs the CLI instead, ``alphadia-torch -f run_4d.d -l
lib.tsv``, on phase [11c]'s inputs (the 4D quarter world as a ``.d`` of the
port's writer, calibration batch 2,000) and prints one JSON line of
``d_readings`` a random state, the values that phase gates:

    PYTHONPATH=. python3 tests/torch_search_step_readings.py --bruker --random-states 0,1,2,3,4,5

The world is ``chip_smoke.py``'s (600 cycles, 80 noise peaks a spectrum,
seed 5) at the given size; ``--peptides 1500 --windows 3`` (3D) and
``--peptides 6250 --windows 3 --mobility --batch-size 2000`` (4D) are the
quarter worlds of the JAX readings (``tests/test_torch_search_step.py``).
Prints one line a random state: steps per optimizer, the final
tolerances, identified share, false share, targets and decoys accepted,
the step's wall, and the device.
"""

from __future__ import annotations

import argparse
import logging
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_workflow_worlds import TOLERANCES, run_search_step, search_id_shares, steps_per_optimizer, write_search_inputs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--peptides", type=int, default=1500)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--mobility", action="store_true")
    ap.add_argument("--batch-size", type=int, default=None, help="calibration.batch_size (default: the config's)")
    ap.add_argument("--random-states", default="0,1,2")
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--bruker", action="store_true", help="the CLI from phase [11c]'s .d (the world options unused)")
    opt = ap.parse_args()
    logging.disable(logging.WARNING)
    where = "cpu"
    if opt.device != "cpu":
        import torch

        where = torch.cuda.get_device_name(0)
    if opt.bruker:
        bruker_readings([int(x) for x in opt.random_states.split(",")], opt.device, where)
        return
    world = dict(
        n_peptides=opt.peptides, n_windows=opt.windows, n_cycles=600, noise_peaks_per_spectrum=80, seed=5,
        with_mobility=opt.mobility,
    )
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        raw_path, lib_path, _, truth = write_search_inputs(tmp, world)
        for rs in (int(x) for x in opt.random_states.split(",")):
            config = {"general": {"random_state": rs, "save_figures": False}}
            if opt.batch_size is not None:
                config["calibration"] = {"batch_size": opt.batch_size}
            t0 = time.perf_counter()
            _, wf, psm = run_search_step(tmp / f"out{rs}", raw_path, lib_path, config, opt.device)
            wall = time.perf_counter() - t0
            om = wf.optimization_manager
            identified, false, n_t, n_d = search_id_shares(wf.dia_data.cycle_rt, truth, psm)
            print(
                f"{opt.peptides} peptides, {opt.windows} windows{', mobility' if opt.mobility else ''}, random state {rs}: "
                f"steps {steps_per_optimizer(wf)}, "
                + ", ".join(f"{k} {float(getattr(om, k)):.4f}" for k in TOLERANCES)
                + f"; identified {identified:.4f}, false {false:.4f}, {n_t} targets, {n_d} decoys; wall {wall:.4f} s "
                f"({where})",
                flush=True,
            )


def bruker_readings(states, device, where) -> None:
    """The port's CLI on phase [11c]'s ``.d`` and TSV library at each random
    state: one JSON line of ``d_readings`` (with the CLI's wall) a state."""
    import hashlib
    import json
    import os

    import alphadia_torch.cli as cli
    from torch_workflow_worlds import D_BATCH, d_readings, d_sha256, write_d_inputs

    if device is not None:
        os.environ["ALPHADIA_TORCH_DEVICE"] = device
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        d_path, lib, truth, cycle_rt, _ = write_d_inputs(tmp)
        print(json.dumps({"d_sha256": d_sha256(d_path), "lib_sha256": hashlib.sha256(lib.read_bytes()).hexdigest()}))
        for state in states:
            out = tmp / f"out{state}"
            argv = ["-o", str(out), "-f", str(d_path), "-l", str(lib), "--config-dict", json.dumps(
                {"general": {"random_state": state, "save_figures": False}, "calibration": {"batch_size": D_BATCH}})]
            t0 = time.perf_counter()
            code = 0
            try:
                cli.run(argv)
            except SystemExit as e:
                code = e.code
            wall = time.perf_counter() - t0
            readings = d_readings(out, truth, cycle_rt) if code == 0 else {}
            print(json.dumps({"random_state": state, "exit": code, **readings, "wall_s": wall, "device": where}),
                  flush=True)


if __name__ == "__main__":
    main()
