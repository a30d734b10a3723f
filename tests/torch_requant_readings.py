"""The JAX CLI's readings of ``chip_smoke.py`` phase [13] on the CPU
(``ALPHADIA_TORCH_DEVICE=cpu``), one JSON line a random state (``--port``
adds the port's on the CPU; the inputs' sha256 first):

    PYTHONPATH=.:tests python tests/torch_requant_readings.py --multiplex --random-state 0 1 2 3 4 5
    PYTHONPATH=.:tests python tests/torch_requant_readings.py --transfer --random-state 0 1 2 3 4 5

``--gather-slab 2048`` reads them with no window overflowing its slab;
``--transfer --world cli`` reads the transfer library on phase [9]'s two
runs instead (they plant a precursor's strongest fragments only).
``--multiplex``: the dimethyl-multiplexed search of phase [13a] (the
precursors per channel); ``--transfer``: ``transfer_library.enabled`` on
the two runs of phase [13b]'s physics world (the scored and the
requantified fragments per run, the transfer library's size).
"""

import json


def _exit_code(run, argv) -> int:
    try:
        run(argv)
    except SystemExit as e:
        return e.code
    return 0


def multiplex_argv(out, raw, lib, state: int, gather_slab: int | None = None) -> list:
    from torch_workflow_worlds import MULTIPLEX_OVERRIDES

    cfg = json.loads(json.dumps(MULTIPLEX_OVERRIDES))
    cfg["general"]["random_state"] = state
    if gather_slab:
        cfg["tpu"]["gather_slab"] = gather_slab
    return ["-o", str(out), "-f", str(raw), "-l", str(lib), "--config-dict", json.dumps(cfg)]


def transfer_argv(out, raws, lib, state: int, gather_slab: int | None = None) -> list:
    cfg = {"general": {"random_state": state, "save_figures": False}, "transfer_library": {"enabled": True}}
    if gather_slab:
        cfg["tpu"] = {"gather_slab": gather_slab}
    return ["-o", str(out), *[a for r in raws for a in ("-f", str(r))], "-l", str(lib), "--config-dict", json.dumps(cfg)]


def main():
    import argparse
    import os
    import tempfile
    from pathlib import Path

    import alphadia_torch.cli as port_cli
    import alphadia_tpu.cli as jax_cli
    from torch_workflow_worlds import (
        CLI_WORLD,
        library_sha256,
        multiplex_readings,
        spectra_sha256,
        transfer_readings,
        write_cli_inputs,
        write_multiplex_inputs,
        write_transfer_inputs,
    )

    ap = argparse.ArgumentParser(description="the JAX CLI's readings of chip_smoke.py phase [13]")
    ap.add_argument("--multiplex", action="store_true")
    ap.add_argument("--transfer", action="store_true")
    ap.add_argument("--random-state", type=int, nargs="+", default=[0])
    ap.add_argument("--port", action="store_true", help="also run the port's CLI on the CPU")
    ap.add_argument("--gather-slab", type=int, default=None, help="tpu.gather_slab (default: the config's 256)")
    ap.add_argument("--world", choices=("physics", "cli"), default="physics", help="--transfer: the runs searched")
    opt = ap.parse_args()
    os.environ["ALPHADIA_TORCH_DEVICE"] = "cpu"
    from alphadia_torch.rawdata.mzml import read_mzml

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if opt.multiplex:
            lib, raw, _, _ = write_multiplex_inputs(tmp)
            print(json.dumps({"inputs": [spectra_sha256(read_mzml(raw)), library_sha256(lib)]}), flush=True)
        elif opt.world == "cli":
            raws, lib, _, _ = write_cli_inputs(tmp, CLI_WORLD)
            print(json.dumps({"inputs": [spectra_sha256(read_mzml(r)) for r in raws]}), flush=True)
        else:
            lib, raws, _, _, _ = write_transfer_inputs(tmp)
            print(json.dumps({"inputs": [spectra_sha256(read_mzml(r)) for r in raws] + [library_sha256(lib)]}),
                  flush=True)
        for state in opt.random_state:
            for who, run in (("jax", jax_cli.run), ("port", port_cli.run))[: 2 if opt.port else 1]:
                out = tmp / f"{who}_{state}"
                if opt.multiplex:
                    code = _exit_code(run, multiplex_argv(out, raw, lib, state, opt.gather_slab))
                    readings = multiplex_readings(out) if code == 0 else {}
                else:
                    code = _exit_code(run, transfer_argv(out, raws, lib, state, opt.gather_slab))
                    readings = transfer_readings(out) if code == 0 else {}
                print(json.dumps({"who": who, "random_state": state, "gather_slab": opt.gather_slab, "exit": code,
                                  **readings}), flush=True)


if __name__ == "__main__":
    main()
