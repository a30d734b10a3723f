"""The readers of the program's spans and counters
(``bench/program_trace.py`` and the seven metric files that use it), on a
hand-built trace and program record: idle gaps under the prep and launch
spans among the trace's outermost host operations, the plain 4D
extractions' stream seconds and the window fill; None where there is
nothing to read, and the program's record taken once a run."""

from types import SimpleNamespace

import pytest

from alphadia_torch.utils import profiling
from perfbench.bench import program_trace
from perfbench.bench.cell import _reader
from perfbench.bench.spec import HERE
from perfbench.bench.trace import Trace

P = program_trace.SPAN_PREFIX
# the host's outermost operations, as Trace.host holds them: disjoint, in order
HOST = [
    (P + "selection.prepare", 50, 150),  # idle 50
    ("aten::copy_", 150, 180),  # not a program span
    (P + "selection.decode", 450, 500),  # idle 50
    (P + "selection.launch", 600, 750),  # idle 100
    (P + "scoring.launch", 790, 850),  # idle 50
    (P + "scoring.assemble", 900, 1100),  # clipped to the stretch: idle 100
]
# device busy [100, 400) and [700, 800): idle [0, 100), [400, 700), [800, 1000)
TRACE = Trace(t0=0, t1=1000, device=[("k", 100, 300), ("k", 250, 400), ("k", 700, 800)], kernels=3, host=HOST)
DEVICE_S = {"ops.xic_4d": 3e-7, "ops.scan_profile": 1e-7, "test.other": 5e-7}
COUNTERS = {"scoring.cells": 120, "scoring.extent_cells": 30}
READINGS = {"prep_idle": 0.2, "launch_idle": 0.15, "plain_xic_share": 0.4, "window_fill": 0.25}
METRICS = ["prep_idle.final", "prep_idle.4d", "launch_idle.final", "launch_idle.4d", "window_fill.final",
           "window_fill.4d", "plain_xic_share.4d"]


def _run(device_s=DEVICE_S, counters=COUNTERS, trace=TRACE):
    return SimpleNamespace(trace=trace, program=(dict(device_s), dict(counters)))


def _read(metric, run):
    return _reader(HERE / "metrics" / f"{metric}.py").read(run)


@pytest.mark.parametrize("metric", METRICS)
def test_each_reader_on_a_hand_built_trace(metric):
    assert _read(metric, _run()) == pytest.approx(READINGS[metric.split(".")[0]])


def test_prep_and_launch_idle_lie_within_the_device_idle():
    from perfbench.bench.readers import device_idle

    run = _run()
    assert program_trace.prep_idle(run) + program_trace.launch_idle(run) <= device_idle(run) + 1e-12


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_to_read_gives_none(metric):
    assert _read(metric, _run(trace=None)) is None
    no_spans = Trace(t0=0, t1=1000, device=TRACE.device, kernels=3, host=HOST[1:2])
    assert _read(metric, SimpleNamespace(trace=no_spans, program=None)) is None
    assert _read(metric, _run(device_s={}, counters={}, trace=no_spans)) is None


def test_a_group_without_spans_or_counters_gives_none():
    prep_only = _run(device_s={}, counters={}, trace=Trace(t0=0, t1=1000, device=TRACE.device, host=HOST[:3]))
    assert program_trace.prep_idle(prep_only) == pytest.approx(0.1)
    assert program_trace.launch_idle(prep_only) is None
    assert program_trace.plain_xic_share(prep_only) is None  # 3D: no plain 4D extractions
    assert program_trace.window_fill(prep_only) is None


def test_the_program_is_taken_once_a_run(monkeypatch):
    taken = []

    def take():
        taken.append(1)
        return dict(DEVICE_S), dict(COUNTERS)

    monkeypatch.setattr(profiling, "take", take)
    run = SimpleNamespace(trace=TRACE)
    got = {m: _read(m, run) for m in METRICS}
    assert taken == [1]
    assert got == {m: pytest.approx(READINGS[m.split(".")[0]]) for m in METRICS}


def test_a_program_without_spans_reads_none(monkeypatch):
    """The parent of the spans: ``utils/profiling`` has no ``take``, and the
    trace holds no program span."""
    monkeypatch.delattr(profiling, "take")
    bare = Trace(t0=0, t1=1000, device=TRACE.device, kernels=3, host=HOST[1:2])
    run = SimpleNamespace(trace=bare)
    assert all(_read(m, run) is None for m in METRICS)
