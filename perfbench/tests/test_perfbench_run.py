"""``run.py`` itself: no result without a card, none outside a checkout of
the program, and no module of JAX or the JAX package in a run."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from tiny import ROOT

from perfbench.bench import cell as cell_mod

ARGS = ["--workload", "astral3d.final", "--seed", "3000000001", "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run(ROOT, env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_no_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the files under paths."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize(
    "names, found",
    [
        (["alphadia_torch", "alphadia_torch.ops"], []),
        (["jax"], ["jax"]),
        (["jaxlib.xla_client"], ["jaxlib"]),
        (["alphadia_tpu.search"], ["alphadia_tpu"]),
        (["flax.linen", "optax"], ["flax", "optax"]),
        (["jaxtyping", "alphadia_tpux", "flaxen"], []),
    ],
)
def test_forbidden_names_compared_whole(monkeypatch, names, found):
    for n in names:
        monkeypatch.setitem(sys.modules, n, object())
    got = cell_mod.forbidden_modules()
    assert [g for g in got if g in {n.split(".")[0] for n in names}] == found


def test_a_run_loads_no_jax(tiny_root, tmp_path):
    """A whole run of a tiny cell in a fresh process: no module of JAX or the
    JAX package is loaded once the window has closed."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
from perfbench.bench import env
env.setup()
from perfbench.bench.cell import run_cell
result, _ = run_cell("tiny3d.final", 5, 0.5, False, 0.0, device="cpu", root={str(tiny_root)!r})
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "alphadia_torch" in top
    assert not top & set(cell_mod.FORBIDDEN)
