"""Profiler hooks: a trace per raw file and named host spans.

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
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path

import torch
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
            path = trace_path(log_dir)
            path.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(path))
            logger.info(f"wrote torch profiler trace to {path}")
        except Exception as exc:
            _warn_once(exc)


def annotate(name: str):
    """Name the enclosed host span in an active trace."""
    return record_function(name)
