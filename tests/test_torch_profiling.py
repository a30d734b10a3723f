"""The port's profiler hooks (``utils/profiling.py``) on the CPU, the
semantics of the JAX package's ``tests/unit/test_profiling.py``:

- ``profile_trace(None)`` does nothing; with a directory it writes one
  Chrome trace, ``trace.json``, holding the spans ``annotate`` named and
  the operators run inside them, and a second trace there ``trace.1.json``;
- ``annotate`` outside a trace costs nothing and changes nothing;
- a phase of ``use_timing_manager`` lands in the timing manager and, as
  ``alphadia_torch.<phase>``, in an active trace;
- a profiler that cannot start is reported once and the work runs;
- ``SearchStep`` with ``general.profile_directory`` writes one trace a raw
  file, ``<dir>/<raw name>/trace.json``, holding that file's phases.
"""

import json
import logging

import numpy as np
import torch

import alphadia_torch.search_step as port_step
from alphadia_torch.search_step import SearchStep
from alphadia_torch.utils import profiling
from alphadia_torch.utils.profiling import TRACE_FILE_NAME, annotate, profile_trace
from alphadia_torch.workflow.managers.timing_manager import TimingManager, use_timing_manager
from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow

pytest_plugins = ("torch_port_plugin",)


def _events(path):
    return json.loads(path.read_text())["traceEvents"]


def test_profile_trace_none_is_noop(tmp_path):
    with profile_trace(None):
        x = torch.ones(4)
    assert float(x.sum()) == 4.0 and not list(tmp_path.iterdir())


def test_profile_trace_writes_one_chrome_trace(tmp_path):
    with profile_trace(tmp_path / "trace"):
        with annotate("unit-test-span"):
            x = torch.ones(64, 64)
            float((x @ x).sum())
    assert [p.name for p in (tmp_path / "trace").iterdir()] == [TRACE_FILE_NAME]
    names = {e.get("name") for e in _events(tmp_path / "trace" / TRACE_FILE_NAME)}
    assert "unit-test-span" in names and "aten::mm" in names
    # a second trace into the same directory (a later step of a plan) keeps the first
    with profile_trace(tmp_path / "trace"):
        with annotate("second-span"):
            torch.ones(3).sum()
    assert sorted(p.name for p in (tmp_path / "trace").iterdir()) == ["trace.1.json", TRACE_FILE_NAME]
    assert "second-span" in {e.get("name") for e in _events(tmp_path / "trace" / "trace.1.json")}


def test_annotate_outside_a_trace_is_safe():
    with annotate("no-active-trace"):
        assert float(torch.arange(4.0).sum()) == 6.0


def test_workflow_phase_lands_in_the_timing_manager_and_the_trace(tmp_path):
    class W:
        timing_manager = TimingManager(path=str(tmp_path / "tm.pkl"))

        @use_timing_manager("demo")
        def work(self):
            return np.int64(7)

    w = W()
    with profile_trace(tmp_path / "t"):
        assert w.work() == 7
    assert w.timing_manager.timings["demo"]["duration"] >= 0
    assert "alphadia_torch.demo" in {e.get("name") for e in _events(tmp_path / "t" / TRACE_FILE_NAME)}


def test_a_profiler_that_cannot_start_warns_once(tmp_path, monkeypatch, caplog):
    class Broken:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            raise RuntimeError("CUPTI_ERROR_NOT_INITIALIZED")

    monkeypatch.setattr(profiling, "profile", Broken)
    monkeypatch.setattr(profiling, "_warned", False)
    ran = []
    with caplog.at_level(logging.WARNING):
        for _ in range(2):
            with profile_trace(tmp_path / "t"):
                ran.append(1)
    assert ran == [1, 1] and not (tmp_path / "t").exists()
    assert sum("torch profiler unavailable" in r.getMessage() for r in caplog.records) == 1


def test_search_step_writes_a_trace_per_raw_file(tmp_path, monkeypatch):
    """Two raw files through the step's per-file loop, the workflow's
    stages replaced by small annotated CPU work: one trace each, holding
    its own three phases."""
    monkeypatch.setattr(SearchStep, "load_library", lambda self: type("Lib", (), {"copy": lambda s: s})())
    monkeypatch.setattr(port_step, "SearchPlanOutput", lambda *a: type("Out", (), {"build": lambda s, *b: None})())
    monkeypatch.setattr(port_step, "write_parquet", lambda *a: None)

    class NoDevice:
        def free_device(self):
            pass

    @use_timing_manager("load")
    def load(self, raw_path, library):
        self.dia_data = NoDevice()
        torch.ones(8).cumsum(0)

    @use_timing_manager("optimization")
    def optimize(self):
        torch.ones(8).sum()

    @use_timing_manager("extraction")
    def extraction(self):
        return {"precursor_idx": np.arange(3)}, {"precursor_idx": np.arange(3)}

    monkeypatch.setattr(PeptideCentricWorkflow, "load", load)
    monkeypatch.setattr(PeptideCentricWorkflow, "search_parameter_optimization", optimize)
    monkeypatch.setattr(PeptideCentricWorkflow, "extraction", extraction)
    prof = tmp_path / "prof"
    s = SearchStep(str(tmp_path / "out"), config={"raw_paths": ["x/a.mzML", "y/b.mzML"],
                                                  "general": {"profile_directory": str(prof)}}, device="cpu")
    s.run()
    assert not s.errors
    assert sorted(p.name for p in prof.iterdir()) == ["a", "b"]
    for run in ("a", "b"):
        names = {e.get("name") for e in _events(prof / run / TRACE_FILE_NAME)}
        assert {"alphadia_torch.load", "alphadia_torch.optimization", "alphadia_torch.extraction"} <= names
