"""Wall-clock phase timings and the ``@use_timing_manager`` decorator."""

from __future__ import annotations

import time
from functools import wraps

import numpy as np
from alphadia_torch.utils.profiling import annotate
from alphadia_torch.workflow.managers.base import BaseManager


class TimingManager(BaseManager):
    def __init__(self, path=None, load_from_file=False):
        super().__init__(path, load_from_file)
        if self.is_loaded_from_file:
            return
        self.timings: dict[str, dict] = {}

    def set_start_time(self, phase: str) -> None:
        self.timings.setdefault(phase, {})["start"] = time.time()

    def set_end_time(self, phase: str) -> None:
        rec = self.timings.setdefault(phase, {})
        rec["end"] = time.time()
        rec["duration"] = rec["end"] - rec.get("start", rec["end"])

    def to_df(self) -> dict:
        """Columns ``phase`` and ``duration`` (seconds), one row a phase."""
        return {
            "phase": np.array(list(self.timings), dtype=object),
            "duration": np.array([v.get("duration", np.nan) for v in self.timings.values()], np.float64),
        }


def use_timing_manager(phase: str):
    """Times a workflow method into ``self.timing_manager``, and names the
    span in an active profiler trace (``utils/profiling``) so that the device timeline
    and the phase durations line up."""

    def deco(fn):
        @wraps(fn)
        def wrapper(self, *args, **kwargs):
            tm = getattr(self, "timing_manager", None)
            if tm is not None:
                tm.set_start_time(phase)
            try:
                with annotate(f"alphadia_torch.{phase}"):
                    return fn(self, *args, **kwargs)
            finally:
                if tm is not None:
                    tm.set_end_time(phase)
                    tm.save()

        return wrapper

    return deco
