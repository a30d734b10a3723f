"""Reporting: console and file logging, and the per-run event stream.

- ``PROGRESS``, a log level between INFO and WARNING, which the workflow
  logs its steps at;
- ``init_logging``: ``log.txt`` in the output directory, a previous log
  kept as ``log.bkp.txt``;
- ``default_pipeline``: a ``Pipeline`` that fans events out to the log
  (``LogBackend``), to the run's ``events.jsonl`` (``JSONLBackend``,
  absolute and relative timestamps for events, metrics and strings) and,
  with ``save_figures``, to ``figures/<name>.png`` (``FigureBackend``: the
  port's own figures, ``reporting/figure.py``). A figure that fails to
  draw or write raises: the renderer has no optional dependency.
"""

from __future__ import annotations

import json
import logging
import shutil
import time
from pathlib import Path

PROGRESS = 25
logging.addLevelName(PROGRESS, "PROGRESS")

# the parent of every module logger of the package
logger = logging.getLogger("alphadia_torch")


def init_logging(output_dir: str | Path | None = None, log_level: str = "INFO") -> None:
    """Configure the package's logger; keep an existing log.txt as .bkp."""
    level = PROGRESS if log_level.upper() == "PROGRESS" else getattr(logging, log_level.upper(), logging.INFO)
    logger.setLevel(min(level, logging.INFO))
    logger.handlers.clear()

    fmt = logging.Formatter("%(asctime)s %(levelname)-8s %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    sh.setLevel(level)
    logger.addHandler(sh)

    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        log_path = output_dir / "log.txt"
        if log_path.exists():
            shutil.copy(log_path, output_dir / "log.bkp.txt")
        fh = logging.FileHandler(log_path, mode="w")
        fh.setFormatter(fmt)
        fh.setLevel(logging.INFO)
        logger.addHandler(fh)


class Backend:
    def context_start(self) -> None: ...
    def context_stop(self) -> None: ...
    def log_event(self, name: str, value=None) -> None: ...
    def log_metric(self, name: str, value: float) -> None: ...
    def log_string(self, message: str, verbosity: str = "info") -> None: ...
    def log_figure(self, name: str, figure) -> None: ...


class LogBackend(Backend):
    def log_event(self, name, value=None):
        logger.info("=== %s %s ===", name, "" if value is None else value)

    def log_metric(self, name, value):
        logger.info("%s: %s", name, value)

    def log_string(self, message, verbosity="info"):
        level = {"debug": logging.DEBUG, "progress": PROGRESS, "warning": logging.WARNING, "error": logging.ERROR}
        logger.log(level.get(verbosity, logging.INFO), message)


class JSONLBackend(Backend):
    """Append-only ``events.jsonl`` with absolute and relative timestamps."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._start = None
        self._fh = None

    def context_start(self):
        self._start = time.time()
        self._fh = open(self.path, "a")
        self._emit("event", "start", None)

    def context_stop(self):
        if self._fh is not None:
            self._emit("event", "stop", None)
            self._fh.close()
            self._fh = None

    def _emit(self, kind, name, value):
        if self._fh is None:
            # opened on first use, so events outside a context still land
            self._start = time.time()
            self._fh = open(self.path, "a")
        now = time.time()
        rec = {"type": kind, "name": name, "value": value, "absolute_time": now, "relative_time": now - (self._start or now)}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def log_event(self, name, value=None):
        self._emit("event", name, value)

    def log_metric(self, name, value):
        self._emit("metric", name, float(value))

    def log_string(self, message, verbosity="info"):
        self._emit("string", verbosity, message)


class FigureBackend(Backend):
    """Each figure as ``<directory>/<name>.png`` at 150 dpi."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)

    def log_figure(self, name, figure):
        self.directory.mkdir(parents=True, exist_ok=True)
        figure.savefig(self.directory / f"{name}.png", dpi=150)


class Pipeline(Backend):
    """Fan-out reporter; a context manager per run."""

    def __init__(self, backends: list[Backend]):
        self.backends = backends

    def __enter__(self):
        self.context_start()
        return self

    def __exit__(self, *exc):
        self.context_stop()
        return False

    def context_start(self):
        for b in self.backends:
            b.context_start()

    def context_stop(self):
        for b in self.backends:
            b.context_stop()

    def log_event(self, name, value=None):
        for b in self.backends:
            b.log_event(name, value)

    def log_metric(self, name, value):
        for b in self.backends:
            b.log_metric(name, value)

    def log_string(self, message, verbosity="info"):
        for b in self.backends:
            b.log_string(message, verbosity)

    def log_figure(self, name, figure):
        for b in self.backends:
            b.log_figure(name, figure)


def default_pipeline(run_dir: str | Path, save_figures: bool = True) -> Pipeline:
    run_dir = Path(run_dir)
    backends: list[Backend] = [LogBackend(), JSONLBackend(run_dir / "events.jsonl")]
    if save_figures:
        backends.append(FigureBackend(run_dir / "figures"))
    return Pipeline(backends)
