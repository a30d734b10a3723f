"""The JAX CLI's readings of ``chip_smoke.py`` phase [13] on the CPU
(``ALPHADIA_TORCH_DEVICE=cpu``), one JSON line a random state (``--port``
adds the port's on the CPU; the inputs' sha256 first):

    PYTHONPATH=.:tests python tests/torch_requant_readings.py --multiplex --random-state 0 1 2 3 4 5
    PYTHONPATH=.:tests python tests/torch_requant_readings.py --transfer --random-state 0 1 2 3 4 5

``--gather-slab 2048`` reads them with no window overflowing its slab;
``--tpu-batch 64`` bounds the memory a large slab takes on the CPU;
``--requant-slab 16384`` raises the transfer requant's slab too (both
packages build its ``ScoringConfig`` at the default 256);
``--packages port --device cuda`` reads the port alone on the card (no JAX
imported);
``--count-overflow`` adds to each line the XIC launches of the run, those
with a window holding more peaks than the slab, their queries, and the
most peaks a window of the run held (the slab no window overflows);
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


def transfer_argv(out, raws, lib, state: int, gather_slab: int | None = None, tpu_batch: int | None = None) -> list:
    cfg = {"general": {"random_state": state, "save_figures": False}, "transfer_library": {"enabled": True}}
    if gather_slab:
        cfg["tpu"] = {"gather_slab": gather_slab}
    if tpu_batch:
        cfg.setdefault("tpu", {}).update(selection_batch=16 * tpu_batch, scoring_batch=tpu_batch)
    return ["-o", str(out), *[a for r in raws for a in ("-f", str(r))], "-l", str(lib), "--config-dict", json.dumps(cfg)]


OVERFLOW = {"launches": 0, "overflowing_launches": 0, "overflowing_queries": 0, "max_window_peaks": 0}


def _record_overflow(over, most) -> None:
    OVERFLOW["launches"] += 1
    OVERFLOW["overflowing_launches"] += int(over) > 0
    OVERFLOW["overflowing_queries"] += int(over)
    OVERFLOW["max_window_peaks"] = max(OVERFLOW["max_window_peaks"], int(most))


def requant_slab(slab: int, packages=("jax", "port")) -> None:
    """Both packages' transfer requant at ``slab``: it builds its
    ``ScoringConfig`` at the default ``gather_slab`` of 256, whatever
    ``tpu.gather_slab`` says."""
    import functools
    import importlib

    for who in packages:
        pkg = {"jax": "alphadia_tpu", "port": "alphadia_torch"}[who]
        handler = importlib.import_module(f"{pkg}.workflow.peptidecentric.transfer_requant_handler")
        handler.ScoringConfig = functools.partial(handler.ScoringConfig, gather_slab=slab)


def count_overflow(packages=("jax", "port")) -> None:
    """Count, in both packages, the XIC launches whose windows hold more
    peaks than their slab: the JAX package's slab read (``ops/xic._one_bin``,
    from the window's first cycle, through a debug callback under jit) and
    the port's wrapper (from the candidate's first cycle) as the kernel
    reads them."""
    import torch

    import alphadia_torch.ops.scoring as port_scoring
    import alphadia_torch.ops.selection as port_selection
    from alphadia_torch.ops.xic import query_rows

    if "jax" in packages:
        _count_jax_overflow()
    wrapper = port_scoring.extract_xic_cuda

    def port_xic(store, cell_start, slot, qmz, tol, c0, **kw):
        row = query_rows(slot, qmz, n_slots=cell_start.shape[0], n_bins=kw["n_bins"],
                         bin_mz_min=kw["bin_mz_min"], bin_width=kw["bin_width"])
        L = cell_start.shape[2]
        lo = row * L + c0.long().clamp(0, kw["n_cycles"])[:, None]
        hi = row * L + (c0.long() + kw.get("window_len", 64)).clamp(0, kw["n_cycles"])[:, None]
        flat = cell_start.reshape(-1)
        n = torch.where(slot >= 0, flat[hi].long() - flat[lo].long(), 0)
        _record_overflow(int((n > kw.get("slab", 256)).sum()), int(n.max()) if n.numel() else 0)
        return wrapper(store, cell_start, slot, qmz, tol, c0, **kw)

    port_scoring.extract_xic_cuda = port_selection.extract_xic_cuda = port_xic


def _count_jax_overflow() -> None:
    import jax
    import jax.numpy as jnp

    import alphadia_tpu.ops.xic as jax_xic

    one_bin = jax_xic._one_bin

    def jax_one_bin(peak_mz, peak_intensity, cs_flat, row, c0, q_lo, q_hi, valid, *, n_cycles, slab, W, **kw):
        cyc = jnp.clip(c0[:, :, None] + jnp.arange(W + 1, dtype=jnp.int32), 0, n_cycles)
        r = jnp.take(cs_flat.reshape(-1), row[:, :, None] * cs_flat.shape[1] + cyc, mode="clip")
        n = jnp.where(valid, r[:, :, -1] - r[:, :, 0], 0)
        jax.debug.callback(_record_overflow, (n > slab).sum(), n.max())
        return one_bin(peak_mz, peak_intensity, cs_flat, row, c0, q_lo, q_hi, valid,
                       n_cycles=n_cycles, slab=slab, W=W, **kw)

    jax_xic._one_bin = jax_one_bin


def main():
    import argparse
    import os
    import tempfile
    from pathlib import Path

    import alphadia_torch.cli as port_cli
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
    ap.add_argument("--packages", nargs="+", choices=("jax", "port"), default=None,
                    help="the CLIs to run (default: jax, and port with --port); the port alone imports no JAX")
    ap.add_argument("--device", default="cpu", help="the port's device (cpu, or cuda on the card)")
    ap.add_argument("--gather-slab", type=int, default=None, help="tpu.gather_slab (default: the config's 256)")
    ap.add_argument("--tpu-batch", type=int, default=None,
                    help="--transfer: tpu.scoring_batch (and 16 times it as tpu.selection_batch), to bound the "
                         "memory of a large --gather-slab on the CPU; with no window overflowing, no feature depends "
                         "on the batch")
    ap.add_argument("--requant-slab", type=int, default=None,
                    help="--transfer: the transfer requant's slab (default: ScoringConfig's 256 in both packages)")
    ap.add_argument("--count-overflow", action="store_true", help="count the launches whose windows overflow")
    ap.add_argument("--world", choices=("physics", "cli"), default="physics", help="--transfer: the runs searched")
    opt = ap.parse_args()
    os.environ["ALPHADIA_TORCH_DEVICE"] = opt.device
    packages = opt.packages or (["jax", "port"] if opt.port else ["jax"])
    runs = {"port": port_cli.run}
    if "jax" in packages:
        import alphadia_tpu.cli as jax_cli

        runs["jax"] = jax_cli.run
    if opt.requant_slab:
        requant_slab(opt.requant_slab, packages)
    if opt.count_overflow:
        count_overflow(packages)
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
            for who in packages:
                run = runs[who]
                out = tmp / f"{who}_{state}"
                OVERFLOW.update(dict.fromkeys(OVERFLOW, 0))
                if opt.multiplex:
                    code = _exit_code(run, multiplex_argv(out, raw, lib, state, opt.gather_slab))
                    readings = multiplex_readings(out) if code == 0 else {}
                else:
                    code = _exit_code(run, transfer_argv(out, raws, lib, state, opt.gather_slab, opt.tpu_batch))
                    readings = transfer_readings(out) if code == 0 else {}
                print(json.dumps({"who": who, "random_state": state, "gather_slab": opt.gather_slab,
                                  "requant_slab": opt.requant_slab, "tpu_batch": opt.tpu_batch, "exit": code,
                                  **readings, **(OVERFLOW if opt.count_overflow else {})}), flush=True)


if __name__ == "__main__":
    main()
