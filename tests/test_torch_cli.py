"""The port's CLI (``alphadia-torch``) against the JAX package's, on the CPU
(``ALPHADIA_TORCH_DEVICE=cpu``).

- The cases of ``tests/unit/test_cli_errors.py`` through both CLIs: the
  same exit codes (127 user error, 126 business error, 1 anything else),
  ``--version``, the reference aliases, ``-d`` with a ``.d`` directory,
  ``output_directory`` from a ``--config`` YAML.
- The transfer step (alone or with the MBR step) and ``--profile-dir``
  reach the plan as in JAX's CLI; without a card and without
  ``ALPHADIA_TORCH_DEVICE=cpu`` the CLI exits non-zero naming the device.
- End to end, ROADMAP queue 1 item 2's gate: both CLIs on the two runs of
  ``tests/e2e/test_cli_e2e.py`` (300 peptides, 6 windows, 350 cycles, seed
  21, acquisition seeds 101 / 202, intensity 1.0 / 1.6, RT shift 0 / 4 s),
  written as mzML with a TSV library whose protein groups overlap, with
  that test's overrides: the 1%-FDR precursor IDs of each run overlap
  JAX's by Jaccard >= 0.95, the protein groups too, and for the groups
  both quantify the ``pg.matrix`` log2 values lie within 0.1 of JAX's in
  median.
"""

import json
import logging

import numpy as np
import pandas as pd
import pytest

import alphadia_torch.cli as port_cli
import alphadia_tpu.cli as jax_cli
from alphadia_torch import search_plan as port_plan
from alphadia_torch.exceptions import NoPsmFoundError
from alphadia_tpu import search_plan as jax_plan
from alphadia_tpu.exceptions import NoPsmFoundError as JaxNoPsmFoundError
from torch_workflow_worlds import E2E_OVERRIDES, E2E_WORLD, write_cli_inputs

pytest_plugins = ("torch_port_plugin",)

JACCARD_MIN = 0.95


@pytest.fixture()
def on_cpu(monkeypatch):
    monkeypatch.setenv("ALPHADIA_TORCH_DEVICE", "cpu")


def _exit_code(run, argv) -> int:
    try:
        run(argv)
    except SystemExit as e:
        return e.code
    return 0


def _both(argv) -> tuple[int, int]:
    return _exit_code(jax_cli.run, argv), _exit_code(port_cli.run, argv)


def test_version(capsys):
    port_cli.run(["--version"])
    assert capsys.readouterr().out.strip().startswith("alphadia-torch ")
    port_cli.run(["--check"])
    assert "alphadia-torch" in capsys.readouterr().out


ERRORS = {
    "no_library": (lambda tmp: ["-o", str(tmp / "out"), "-f", str(tmp / "run.npz")], 127),
    "unknown_config_key": (lambda tmp: ["-o", str(tmp / "out"), "-f", "x.npz", "--config-dict", json.dumps({"no_such_key": 1})], 127),
    "missing_config_file": (lambda tmp: ["-o", str(tmp / "out"), "--config", str(tmp / "missing.yaml")], 127),
    "malformed_config_dict": (lambda tmp: ["-o", str(tmp / "out"), "--config-dict", "{not json"], 127),
    "missing_directory": (lambda tmp: ["-o", str(tmp / "out"), "-d", str(tmp / "missing")], 127),
    "no_output": (lambda tmp: ["-f", "x.npz"], 127),
}


@pytest.mark.parametrize("case", ERRORS)
def test_user_errors_exit_as_jax(tmp_path, on_cpu, case):
    make, code = ERRORS[case]
    (tmp_path / "run.npz").write_bytes(b"")
    assert _both(make(tmp_path)) == (code, code)


@pytest.mark.parametrize("error,code", [("business", 126), ("unknown", 1)])
def test_deeper_errors_exit_as_jax(tmp_path, on_cpu, monkeypatch, error, code):
    for module, business in ((jax_plan, JaxNoPsmFoundError), (port_plan, NoPsmFoundError)):
        def boom(self, business=business):
            raise business() if error == "business" else RuntimeError("disk on fire")

        monkeypatch.setattr(module.SearchPlan, "run_plan", boom)
    assert _both(["-o", str(tmp_path / "out"), "-f", "x.npz"]) == (code, code)


def test_config_file_directory_scan_and_aliases(tmp_path, on_cpu, monkeypatch):
    seen = {}
    for who, module in (("jax", jax_plan), ("port", port_plan)):
        monkeypatch.setattr(module.SearchPlan, "run_plan",
                            lambda self, who=who: seen.setdefault(who, (str(self.output_directory), self.cli_config)))
    (tmp_path / "sample1.d").mkdir()
    (tmp_path / "run2.mzML").write_text("")
    (tmp_path / "notes.txt").write_text("")
    cfg = tmp_path / "run.yaml"
    cfg.write_text(f"output_directory: {tmp_path / 'res'}\nsearch:\n  target_ms2_tolerance: 15.0  # ppm\n")
    argv = ["--config", str(cfg), "--directory", str(tmp_path), "--regex", r"\.(d|mzML)$", "--library-path", "lib.tsv",
            "--fasta-path", "db.fasta", "--quant-directory", str(tmp_path / "q"), "--config-dict", '{"general": {"thread_count": 2}}']
    assert _both(argv) == (0, 0)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == str(tmp_path / "res")
    assert [p.rsplit("/", 1)[-1] for p in seen["port"][1]["raw_paths"]] == ["run2.mzML", "sample1.d"]
    a = port_cli._build_parser().parse_args(["--output-directory", "/o", "--raw-path", "a.mzML", "-r", "x", "-c", "c.yaml"])
    assert (a.output, a.file, a.regex, a.config) == ("/o", ["a.mzML"], "x", "c.yaml")


LATER_FLAGS = {
    "transfer_step": (["--config-dict", json.dumps({"general": {"transfer_step_enabled": True}})],
                      {"transfer_step_enabled": True}),
    "transfer_and_mbr_steps": (
        ["--config-dict", json.dumps({"general": {"transfer_step_enabled": True, "mbr_step_enabled": True}})],
        {"transfer_step_enabled": True, "mbr_step_enabled": True},
    ),
    "profile_dir": (["--profile-dir", "prof"], {"profile_directory": "prof"}),
}


@pytest.mark.parametrize("case", LATER_FLAGS)
def test_transfer_steps_and_profile_dir_reach_the_plan_as_jax(tmp_path, on_cpu, monkeypatch, case):
    """The transfer step (alone or with the MBR step) and ``--profile-dir``
    reach ``SearchPlan`` in the CLI config layer of JAX's CLI, and the plan
    runs (each package's ``run_plan`` recorded)."""
    extra, general = LATER_FLAGS[case]
    seen = {}
    for who, module in (("jax", jax_plan), ("port", port_plan)):
        monkeypatch.setattr(module.SearchPlan, "run_plan", lambda self, who=who: seen.setdefault(
            who, (str(self.output_directory), self.cli_config, self.transfer_step_enabled, self.mbr_step_enabled)))
    argv = ["-o", str(tmp_path / "out"), "-f", "x.mzML", "-l", "lib.tsv", *extra]
    assert _both(argv) == (0, 0)
    assert seen["port"] == seen["jax"]
    assert seen["port"][1]["general"] == general
    assert seen["port"][2:] == (general.get("transfer_step_enabled", False), general.get("mbr_step_enabled", False))


def test_no_card_without_the_cpu_asked_for(tmp_path, monkeypatch, caplog):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.delenv("ALPHADIA_TORCH_DEVICE", raising=False)
    with caplog.at_level(logging.ERROR, logger="alphadia_torch"):
        code = _exit_code(port_cli.run, ["-o", str(tmp_path / "out"), "-f", "x.mzML", "-l", "lib.tsv"])
    assert code != 0
    assert any("CUDA device" in r.getMessage() and "ALPHADIA_TORCH_DEVICE" in r.getMessage() for r in caplog.records)
    monkeypatch.setenv("ALPHADIA_TORCH_DEVICE", "tpu")
    assert _exit_code(port_cli.run, ["-o", str(tmp_path / "out"), "-f", "x.mzML"]) == 127


# ---------------------------------------------------------------------------
# end to end against the JAX CLI
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_e2e")
    raws, lib, _, _ = write_cli_inputs(tmp, E2E_WORLD)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALPHADIA_TORCH_DEVICE", "cpu")
        for who, run in (("jax", jax_cli.run), ("port", port_cli.run)):
            argv = ["-o", str(tmp / who), "-f", str(raws[0]), "-f", str(raws[1]), "-l", str(lib),
                    "--config-dict", json.dumps(E2E_OVERRIDES)]
            assert _exit_code(run, argv) == 0, who
            out[who] = tmp / who
    return out


def test_e2e_writes_the_tables(e2e):
    for name in ("precursors.parquet", "pg.matrix.parquet", "precursor.matrix.parquet", "peptide.matrix.parquet",
                 "stat.tsv", "internal.tsv", "frozen_config.yaml"):
        assert (e2e["port"] / name).exists(), name
    want, got = (pd.read_parquet(e2e[w] / "precursors.parquet") for w in ("jax", "port"))
    assert list(got.columns) == list(want.columns)
    assert got["raw.name"].nunique() == 2
    want, got = (pd.read_csv(e2e[w] / "stat.tsv", sep="\t") for w in ("jax", "port"))
    assert list(got.columns) == list(want.columns) and len(got) == 2
    # each package's own optimization: the tolerances agree within 5%
    for c in [c for c in want.columns if c.startswith("optimization.")]:
        np.testing.assert_allclose(got[c], want[c], rtol=0.05, err_msg=c)


def _ids(psm: pd.DataFrame, run: str) -> set:
    sel = psm[(psm["raw.name"] == run) & (psm["precursor.qval"] <= 0.01) & (psm["precursor.decoy"] == 0)]
    return set(zip(sel["precursor.sequence"], sel["precursor.charge"]))


def _jaccard(a: set, b: set) -> float:
    return len(a & b) / max(len(a | b), 1)


def test_e2e_ids_and_protein_groups_overlap_jax(e2e):
    want, got = (pd.read_parquet(e2e[w] / "precursors.parquet") for w in ("jax", "port"))
    for run in ("run_0", "run_1"):
        a, b = _ids(want, run), _ids(got, run)
        assert len(a) > 150
        assert _jaccard(a, b) >= JACCARD_MIN, run
    assert _jaccard(set(want["pg.name"]), set(got["pg.name"])) >= JACCARD_MIN


def test_e2e_protein_quantities_match_jax(e2e):
    want, got = (pd.read_parquet(e2e[w] / "pg.matrix.parquet").set_index("group") for w in ("jax", "port"))
    common = want.index.intersection(got.index)
    assert len(common) >= JACCARD_MIN * len(want.index.union(got.index))
    diff = np.log2(got.loc[common, ["run_0", "run_1"]].to_numpy()) - np.log2(want.loc[common, ["run_0", "run_1"]].to_numpy())
    assert np.nanmedian(np.abs(diff)) <= 0.1


def main():
    """The JAX CLI (and with ``--port`` the port's, on the CPU) on the two
    runs of phase [9] of ``chip_smoke.py``: one JSON line of
    ``cli_readings`` a package and random state, the readings its gates
    are taken from."""
    import argparse
    import tempfile
    from pathlib import Path

    from torch_workflow_worlds import CLI_WORLD, cli_readings

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--peptides", type=int, default=CLI_WORLD["n_peptides"])
    ap.add_argument("--windows", type=int, default=CLI_WORLD["n_windows"])
    ap.add_argument("--random-state", type=int, nargs="+", default=[0])
    ap.add_argument("--port", action="store_true", help="also run the port's CLI on the CPU")
    opt = ap.parse_args()
    world = {**CLI_WORLD, "n_peptides": opt.peptides, "n_windows": opt.windows}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        raws, lib, truth, cycle_rts = write_cli_inputs(tmp, world)
        for state in opt.random_state:
            for who, run in (("jax", jax_cli.run), ("port", port_cli.run))[: 2 if opt.port else 1]:
                import os

                os.environ["ALPHADIA_TORCH_DEVICE"] = "cpu"
                out = tmp / f"{who}_{state}"
                argv = ["-o", str(out), "-f", str(raws[0]), "-f", str(raws[1]), "-l", str(lib), "--config-dict",
                        json.dumps({"general": {"random_state": state, "save_figures": False}})]
                code = _exit_code(run, argv)
                print(json.dumps({"who": who, "random_state": state, "exit": code,
                                  **(cli_readings(out, truth, cycle_rts) if code == 0 else {})}), flush=True)


if __name__ == "__main__":
    main()
