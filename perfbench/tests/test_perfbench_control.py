"""The control (the reference one precision step down, in the program's
place) comes out not correct under each cell's limits, at a size that a test
run holds; the program on the CPU comes out correct there."""

import json

import pytest

from tiny import ROOT
from perfbench.control import readings

CELLS = {"tiny3d.final": "astral3d.final", "tiny4d.final": "timstof4d.final"}


@pytest.mark.parametrize("tiny_cell", sorted(CELLS))
def test_control_fails_the_cells_limits(tiny_root, tiny_cell):
    limits = json.loads((ROOT / "perfbench" / "checks" / f"{CELLS[tiny_cell]}.json").read_text())["limits"]
    prog, info = readings(tiny_cell, 2**31 + 99, 0.5, device="cpu", root=tiny_root)
    ctl = info["control"]
    assert info["sampled precursors"] >= 100
    assert all(prog[k] <= limits[k] for k in prog), prog
    assert any(ctl[k] > limits[k] for k in ctl), ctl
