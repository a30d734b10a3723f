"""Match-between-runs (MBR): the port's search plan against the JAX
package's, on the CPU (``ALPHADIA_TORCH_DEVICE=cpu``).

- Both CLIs run the MBR plan (``general.mbr_step_enabled``: the library
  step in ``library/`` writing ``speclib.mbr.hdf``, then the MBR step over
  the same runs with that flat library) on the two runs of
  ``tests/e2e/test_cli_e2e.py`` written as alphaRaw ``.hdf`` (the port's
  writer) with a TSV library, with that test's overrides and
  ``save_library`` / ``save_flat_library`` on. At the MBR step the 1%-FDR
  precursor IDs of each run overlap JAX's by Jaccard >= 0.95, the protein
  groups too; the MBR libraries hold the same precursors within 5%.
- ``MbrLibraryBuilder`` + ``save_hdf``: both packages' ``SearchPlanOutput``
  on the JAX library step's per-run files, each with its own package's flat
  library of the same TSV, write ``speclib.mbr.hdf`` files that both
  packages read equal.

Run as a script, it prints the JAX CLI's readings of ``chip_smoke.py``
phase [12c] (the MBR plan on phase [9]'s two runs written as alphaRaw
``.hdf``), one JSON line a random state; ``--port`` adds the port's on the
CPU:

    PYTHONPATH=.:tests python tests/test_torch_mbr.py --random-state 0 1 2 [--port]
"""

import json

import numpy as np
import pandas as pd
import pytest

import alphadia_torch.cli as port_cli
import alphadia_tpu.cli as jax_cli
from torch_workflow_worlds import E2E_OVERRIDES, E2E_WORLD, write_cli_inputs

pytest_plugins = ("torch_port_plugin",)

JACCARD_MIN = 0.95
MBR_CONFIG = {"general": {"mbr_step_enabled": True, "save_library": True, "save_flat_library": True}}


def _exit_code(run, argv) -> int:
    try:
        run(argv)
    except SystemExit as e:
        return e.code
    return 0


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def mbr_argv(out, raws, lib, config: dict) -> list:
    return ["-o", str(out), *[a for r in raws for a in ("-f", str(r))], "-l", str(lib),
            "--config-dict", json.dumps(_merge(config, MBR_CONFIG))]


@pytest.fixture(scope="module")
def mbr(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mbr")
    raws, lib, _, _ = write_cli_inputs(tmp, E2E_WORLD, raw_format="hdf")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALPHADIA_TORCH_DEVICE", "cpu")
        for who, run in (("jax", jax_cli.run), ("port", port_cli.run)):
            assert _exit_code(run, mbr_argv(tmp / who, raws, lib, E2E_OVERRIDES)) == 0, who
            out[who] = tmp / who
    return out, lib, tmp


def _ids(psm: pd.DataFrame, run: str) -> set:
    sel = psm[(psm["raw.name"] == run) & (psm["precursor.qval"] <= 0.01) & (psm["precursor.decoy"] == 0)]
    return set(zip(sel["precursor.sequence"], sel["precursor.charge"]))


def _jaccard(a: set, b: set) -> float:
    return len(a & b) / max(len(a | b), 1)


def test_mbr_plan_writes_both_steps(mbr):
    out, _, _ = mbr
    for who in ("jax", "port"):
        for folder in (out[who] / "library", out[who]):
            for name in ("precursors.parquet", "pg.matrix.parquet", "stat.tsv", "speclib.mbr.hdf"):
                assert (folder / name).exists(), (who, folder, name)
            assert (folder / "quant" / "run_1" / "psm.parquet").exists()
        # the libraries saved where one is built: the library step (the MBR
        # step's flat input gets its decoys only)
        for name in ("speclib.hdf", "speclib.flat.hdf"):
            assert (out[who] / "library" / name).exists() and not (out[who] / name).exists(), (who, name)


def test_mbr_step_ids_and_protein_groups_overlap_jax(mbr):
    out, _, _ = mbr
    want, got = (pd.read_parquet(out[w] / "precursors.parquet") for w in ("jax", "port"))
    for run in ("run_0", "run_1"):
        a, b = _ids(want, run), _ids(got, run)
        assert len(a) > 150
        assert _jaccard(a, b) >= JACCARD_MIN, run
    assert _jaccard(set(want["pg.name"]), set(got["pg.name"])) >= JACCARD_MIN


def test_mbr_libraries_hold_the_same_precursors(mbr):
    from alphadia_torch.library.loader import load_speclib_hdf
    from alphadia_tpu.library.loader import load_speclib_hdf as jax_load_speclib_hdf

    out, _, _ = mbr
    ours = load_speclib_hdf(out["port"] / "library" / "speclib.mbr.hdf")
    theirs = jax_load_speclib_hdf(out["jax"] / "library" / "speclib.mbr.hdf")
    key = ("sequence", "charge")
    a = set(zip(*(theirs.precursor_df[k].tolist() for k in key)))
    b = set(zip(*(np.asarray(ours.precursor_df[k]).tolist() for k in key)))
    assert len(a) > 150 and _jaccard(a, b) >= JACCARD_MIN
    assert abs(len(b) - len(a)) <= 0.05 * len(a)
    # the MBR step searched that library
    for who in ("jax", "port"):
        frozen = (out[who] / "frozen_config.yaml").read_text()
        assert str(out[who] / "library" / "speclib.mbr.hdf") in frozen and "input_library_type: flat" in frozen


def test_mbr_library_builder_matches_jax_on_the_same_files(mbr, tmp_path):
    """Each package's ``SearchPlanOutput`` with ``save_mbr_library`` on the
    JAX library step's per-run folders and its own flat library of the same
    TSV: the two ``speclib.mbr.hdf`` are read equal by both packages."""
    from alphadia_torch.config import load_default_config
    from alphadia_torch.library.loader import load_speclib_hdf
    from alphadia_torch.outputs.search_plan_output import SearchPlanOutput
    from alphadia_torch.search_step import SearchStep
    from alphadia_tpu.config import load_default_config as jax_load_default_config
    from alphadia_tpu.library.loader import load_speclib_hdf as jax_load_speclib_hdf
    from alphadia_tpu.outputs.search_plan_output import SearchPlanOutput as JaxSearchPlanOutput
    from alphadia_tpu.search_step import SearchStep as JaxSearchStep

    out, lib, _ = mbr
    folders = [out["jax"] / "library" / "quant" / f"run_{i}" for i in range(2)]
    cfg = {**E2E_OVERRIDES, "library_path": str(lib)}
    patch = {"general": {"save_mbr_library": True}}
    theirs_cfg, ours_cfg = jax_load_default_config(), load_default_config()
    theirs_cfg.update_layer(patch)
    ours_cfg.update_layer(patch)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    JaxSearchPlanOutput(theirs_cfg, tmp_path / "j").build(folders, JaxSearchStep(str(tmp_path / "js"), config=cfg).load_library())
    SearchPlanOutput(ours_cfg, tmp_path / "p").build(
        folders, SearchStep(str(tmp_path / "ps"), config=cfg, device="cpu").load_library()
    )
    libs = {who: (load_speclib_hdf(tmp_path / who / "speclib.mbr.hdf"),
                  jax_load_speclib_hdf(tmp_path / who / "speclib.mbr.hdf")) for who in ("j", "p")}
    ref = libs["j"][1]
    assert len(ref.precursor_df) > 150
    for who, (ours, theirs) in libs.items():
        for name in ("precursor_df", "fragment_df"):
            want, jax_read, port_read = getattr(ref, name), getattr(theirs, name), getattr(ours, name)
            assert list(want.columns) == list(jax_read.columns) == list(port_read), (who, name)
            for c in want.columns:
                a, b, p = want[c].to_numpy(), jax_read[c].to_numpy(), np.asarray(port_read[c])
                assert a.dtype == b.dtype and (p.dtype == a.dtype or (a.dtype == object and p.dtype == object)), c
                assert a.tolist() == b.tolist() == p.tolist() or (
                    a.dtype.kind == "f" and np.array_equal(a, b, equal_nan=True) and np.array_equal(a, p, equal_nan=True)
                ), (who, name, c)


def main():
    import argparse
    import os
    import tempfile
    from pathlib import Path

    from alphadia_torch.library.loader import load_speclib_hdf
    from torch_workflow_worlds import CLI_WORLD, cli_readings

    ap = argparse.ArgumentParser(description="the MBR plan through the JAX CLI on phase [12c]'s inputs")
    ap.add_argument("--random-state", type=int, nargs="+", default=[0])
    ap.add_argument("--port", action="store_true", help="also run the port's CLI on the CPU")
    opt = ap.parse_args()
    os.environ["ALPHADIA_TORCH_DEVICE"] = "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        raws, lib, truth, cycle_rts = write_cli_inputs(tmp, CLI_WORLD, raw_format="hdf")
        from alphadia_torch.rawdata.hdf import read_alpharaw_hdf
        from torch_workflow_worlds import spectra_sha256

        print(json.dumps({"inputs": [spectra_sha256(read_alpharaw_hdf(r)) for r in raws]}), flush=True)
        for state in opt.random_state:
            for who, run in (("jax", jax_cli.run), ("port", port_cli.run))[: 2 if opt.port else 1]:
                out = tmp / f"{who}_{state}"
                code = _exit_code(run, mbr_argv(out, raws, lib, {"general": {"random_state": state, "save_figures": False}}))
                readings = {}
                if code == 0:
                    readings = cli_readings(out, truth, cycle_rts)
                    readings["mbr_library_precursors"] = len(
                        load_speclib_hdf(out / "library" / "speclib.mbr.hdf").precursor_df["precursor_idx"]
                    )
                    lib_step = cli_readings(out / "library", truth, cycle_rts)
                    readings.update({f"library_{k}": v for k, v in lib_step.items() if k.startswith(("identified", "false"))})
                print(json.dumps({"who": who, "random_state": state, "exit": code, **readings}), flush=True)


if __name__ == "__main__":
    main()
