"""Profiler hooks: a trace per raw file, named host spans, and the drivers'
own spans and counters.

    with profile_trace("prof/run_0"):      # writes prof/run_0/trace.json
        with annotate("alphadia_torch.extraction"):
            ...

``profile_trace`` records the enclosed work with ``torch.profiler``: the
host's operators and, where CUDA is available, the card's kernels and
copies (CUPTI), and writes them as one Chrome trace, ``trace.json`` in
``log_dir`` (``trace.1.json`` and on where one is there; load it in
``chrome://tracing`` or Perfetto). With no
``log_dir`` it does nothing. ``annotate`` names a host span
(``torch.profiler.record_function``), which lands in an active trace and
costs a few microseconds otherwise; ``use_timing_manager`` names every
workflow phase with it, so that the trace and the phase durations line up.

Enable per run with ``general.profile_directory`` or ``alphadia-torch
--profile-dir DIR``: the search step traces each raw file's ``load`` ->
``search_parameter_optimization`` -> ``extraction`` into ``DIR/<raw
name>``. A profiler that cannot start or stop (no CUPTI on the host, say)
is reported by one warning, and the search runs on untraced.

**Spans and counters.** The extraction drivers and the 4D extractions
(``ops/scan_cells_cuda``) mark their phases with ``span(name)`` and count
their work with ``count(name, n)``:

- the gate: both record only while a ``torch.profiler`` session is active
  (``profile_trace``, or any other session of the process). With none, a
  span or counter site costs one flag check and allocates nothing, and
  the sites that compute what they count test ``enabled()`` first;
- a span is a profiler range ``alphadia_torch.<name>``, so the driver
  phases appear in ``trace.json`` under ``alphadia_torch.*`` (among the
  workflow phases, which ``use_timing_manager`` names the same way), on the
  clock of the trace's device events. The range is a host operator
  (``_RecordFunctionFast``), not a user annotation: the profiler mirrors
  each ``record_function`` range that launches work onto the card's
  timeline as a device-side range, which a reader of the trace's device
  intervals would take for device work. The phases are siblings: none
  encloses a whole driver call, so each stretch in which the card idles
  lies under the phase the host was in. A span given a CUDA ``device``
  also records a pair of timing events on that device's current stream
  around its work;
- a counter adds a number to a total of its name;
- ``take()`` returns the device spans' seconds on their streams, summed by
  name (after one synchronize of each card they lie on), and the counters,
  and clears both. ``profile_trace`` clears them when its session ends:
  its spans are in its trace.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from pathlib import Path

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile, record_function

logger = logging.getLogger(__name__)

TRACE_FILE_NAME = "trace.json"

_warned = False


def _warn_once(exc: Exception) -> None:
    global _warned
    if not _warned:
        logger.warning(f"torch profiler unavailable: {exc!r}")
        _warned = True


def trace_path(log_dir: str | Path) -> Path:
    """``log_dir/trace.json``, or ``trace.<n>.json`` with the first free
    ``n`` where a trace is there (the steps of a search plan trace the same
    raw file into the same directory)."""
    path, n = Path(log_dir) / TRACE_FILE_NAME, 0
    while path.exists():
        n += 1
        path = Path(log_dir) / f"trace.{n}.json"
    return path


@contextlib.contextmanager
def profile_trace(log_dir: str | Path | None):
    """Trace the enclosed work into ``log_dir`` (nothing without it)."""
    if not log_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
    except Exception as exc:
        _warn_once(exc)
        yield
        return
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            _recorder.clear()
            path = trace_path(log_dir)
            path.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(path))
            logger.info(f"wrote torch profiler trace to {path}")
        except Exception as exc:
            _warn_once(exc)


def annotate(name: str):
    """Name the enclosed host span in an active trace."""
    return record_function(name)


SPAN_PREFIX = "alphadia_torch."

enabled = torch._C._autograd._profiler_enabled  # true while a torch.profiler session is active

_NULL = contextlib.nullcontext()


class _Recorder:
    """The device spans' event pairs and the counters recorded while a
    profiler session is active."""

    def __init__(self):
        self.lock = threading.Lock()
        self.pairs: list = []  # (name, stream, start event, end event)
        self.counts: dict[str, int] = {}

    def clear(self) -> tuple[list, dict]:
        with self.lock:
            pairs, counts = self.pairs, self.counts
            self.pairs, self.counts = [], {}
        return pairs, counts


_recorder = _Recorder()


class _Span:
    __slots__ = ("name", "mark", "events")

    def __init__(self, name: str, device):
        self.name = name
        self.mark = _RecordFunctionFast(SPAN_PREFIX + name)
        self.events = None
        if device is not None and device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            self.events = (stream, torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        self.mark.__enter__()
        if self.events is not None:
            self.events[1].record(self.events[0])
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[2].record(self.events[0])
            with _recorder.lock:
                _recorder.pairs.append((self.name, *self.events))
        self.mark.__exit__(*exc)
        return False


def span(name: str, device: torch.device | None = None):
    """A program span ``alphadia_torch.<name>`` around the enclosed work
    while a profiler session is active (a shared no-op otherwise). With a
    CUDA ``device``, a pair of timing events on its current stream too."""
    if not enabled():
        return _NULL
    return _Span(name, device)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while a profiler session is active."""
    if enabled():
        with _recorder.lock:
            _recorder.counts[name] = _recorder.counts.get(name, 0) + int(n)


def take() -> tuple[dict[str, float], dict[str, int]]:
    """The device spans' seconds on their streams, summed by name, and the
    counters, recorded since the last ``take``; both cleared."""
    pairs, counts = _recorder.clear()
    for dev in {stream.device for _, stream, _, _ in pairs}:
        torch.cuda.synchronize(dev)
    seconds: dict[str, float] = {}
    for name, _, start, end in pairs:
        seconds[name] = seconds.get(name, 0.0) + start.elapsed_time(end) * 1e-3
    return seconds, counts
