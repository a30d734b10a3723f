"""The JAX CLI's readings of ``chip_smoke.py`` phase [14] on the CPU
(``ALPHADIA_TORCH_DEVICE=cpu``), one JSON line a random state (``--port``
adds the port's on the CPU; the inputs' sha256 first):

    PYTHONPATH=.:tests python tests/torch_multistep_readings.py --random-state 0 1 2 3 4 5
    PYTHONPATH=.:tests python tests/torch_multistep_readings.py --random-state 0 1 2 3 4 5 --packages port --device cuda

The three-step plan (``general.transfer_step_enabled`` and
``mbr_step_enabled``) library-free on the physics world of phase [13b]
(``torch_workflow_worlds.write_transfer_inputs``: the 20-protein FASTA,
two runs planting every b/y fragment): the transfer library's size, the
tuned models' metrics, each later step's IDs per run and protein groups,
the MBR library's size (``torch_workflow_worlds.multistep_readings``).
``--packages port --device cuda`` reads the port alone on the card (no JAX
imported). ``--random-state`` takes one or more states.
"""

import hashlib
import json


def _exit_code(run, argv) -> int:
    try:
        run(argv)
    except SystemExit as e:
        return e.code
    return 0


def main():
    import argparse
    import os
    import tempfile
    from pathlib import Path

    import alphadia_torch.cli as port_cli
    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.rawdata.mzml import read_mzml
    from torch_workflow_worlds import (
        multistep_argv,
        multistep_readings,
        physics_truth,
        spectra_sha256,
        write_transfer_inputs,
    )

    ap = argparse.ArgumentParser(description="the JAX CLI's readings of chip_smoke.py phase [14]")
    ap.add_argument("--random-state", type=int, nargs="+", default=[0])
    ap.add_argument("--port", action="store_true", help="also run the port's CLI on the CPU")
    ap.add_argument("--packages", nargs="+", choices=("jax", "port"), default=None,
                    help="the CLIs to run (default: jax, and port with --port); the port alone imports no JAX")
    ap.add_argument("--device", default="cpu", help="the port's device (cpu, or cuda on the card)")
    opt = ap.parse_args()
    os.environ["ALPHADIA_TORCH_DEVICE"] = opt.device
    packages = opt.packages or (["jax", "port"] if opt.port else ["jax"])
    runs = {"port": port_cli.run}
    if "jax" in packages:
        import alphadia_tpu.cli as jax_cli

        runs["jax"] = jax_cli.run
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _, raws, planted, _, _ = write_transfer_inputs(tmp)
        fasta = tmp / "db.fasta"
        spectra = [read_mzml(r) for r in raws]
        cycle_rts = [DiaData.from_spectra(s).cycle_rt for s in spectra]
        print(json.dumps({"inputs": [spectra_sha256(s) for s in spectra] + [hashlib.sha256(fasta.read_bytes()).hexdigest()]}),
              flush=True)
        truth = physics_truth(planted)
        for state in opt.random_state:
            for who in packages:
                out = tmp / f"{who}_{state}"
                code = _exit_code(runs[who], multistep_argv(out, raws, fasta, state))
                readings = multistep_readings(out, truth, cycle_rts) if code == 0 else {}
                print(json.dumps({"who": who, "random_state": state, "exit": code, **readings}), flush=True)


if __name__ == "__main__":
    main()
