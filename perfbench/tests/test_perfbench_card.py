"""On the card: one short run of each cell through ``run.py``, its result
line well formed and correct. Skips where no card is found."""

import json
import subprocess
import sys

import pytest
import torch

from tiny import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["astral3d.final", "timstof4d.final"])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed", "4000000007", "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert result["correct"], proc.stderr[-4000:]
