"""The benchmark's spans and its reading of the profiler's trace.

``Spans`` records named host intervals around the calls a loop makes into
the program (perf_counter, always on) and, while a trace runs, marks them in
the trace too (``record_function``, names ``bench.*``). ``Tracer`` holds a
``torch.profiler`` session over a stretch of the window and turns its events
into a :class:`Trace`: device intervals (kernels, copies, sets), the
benchmark's spans and the host's outermost operations on the profiler's
clock. Nothing of the program is wrapped or patched.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

PREFIX = "bench."

class Spans:
    def __init__(self):
        self.records: list[tuple[str, float, float]] = []  # (name, start, end), perf_counter seconds
        self.marking = False

    @contextlib.contextmanager
    def span(self, name: str):
        mark = torch.profiler.record_function(PREFIX + name) if self.marking else contextlib.nullcontext()
        t0 = time.perf_counter()
        with mark:
            try:
                yield
            finally:
                self.records.append((name, t0, time.perf_counter()))


@dataclass
class Trace:
    """Events of one traced stretch, in nanoseconds on the profiler's clock."""

    t0: int
    t1: int
    device: list = field(default_factory=list)  # (name, start, end) of each device operation
    kernels: int = 0  # device operations that are kernels (not copies or sets)
    spans: list = field(default_factory=list)  # (name, start, end) of the benchmark's spans
    host: list = field(default_factory=list)  # (name, start, end) of the host's outermost operations

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_s(self) -> float:
        """Seconds of the stretch in which some device operation ran (the
        union of their intervals)."""
        if not self.device:
            return 0.0
        iv = np.array([(max(a, self.t0), min(b, self.t1)) for _, a, b in self.device], np.int64)
        iv = iv[iv[:, 1] > iv[:, 0]]
        if not len(iv):
            return 0.0
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        ends = np.maximum.accumulate(iv[:, 1])
        # a new block starts where an interval begins after every earlier end
        starts_new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
        block = np.cumsum(starts_new) - 1
        b_start = iv[starts_new, 0]
        b_end = np.zeros(len(b_start), np.int64)
        np.maximum.at(b_end, block, iv[:, 1])
        return float((b_end - b_start).sum()) * 1e-9

    def idle_gaps(self) -> list[tuple[int, int]]:
        """The stretches with no device operation running, in order."""
        iv = sorted((max(a, self.t0), min(b, self.t1)) for _, a, b in self.device)
        gaps, at = [], self.t0
        for a, b in iv:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def device_time(self, match) -> float:
        """Seconds of device operations whose name ``match`` accepts."""
        return sum(b - a for n, a, b in self.device if match(n)) * 1e-9

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing in the middle of each gap: the innermost
        benchmark span open then, and the host's outermost operation
        (``python`` where none ran), at most ``n`` each."""
        ops: dict[str, int] = {}
        for name, a, b in self.device:
            ops[name] = ops.get(name, 0) + (b - a)
        idle: dict[str, int] = {}
        starts = sorted(self.spans, key=lambda s: s[1])
        host = sorted(self.host, key=lambda s: s[1])
        host_starts = np.array([a for _, a, _ in host], np.int64)
        for a, b in self.idle_gaps():
            mid = (a + b) // 2
            k = int(np.searchsorted(host_starts, mid, side="right")) - 1
            op = host[k][0] if k >= 0 and host[k][2] > mid else "python"
            key = _innermost(starts, mid) + " / " + op
            idle[key] = idle.get(key, 0) + (b - a)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:n]
        return {
            "device_ops": [[name[:200], ns * 1e-9] for name, ns in top],
            "idle_gaps": [[name, ns * 1e-9] for name, ns in gaps],
        }


def _innermost(spans, t):
    best, best_len = "outside", None
    for name, a, b in spans:
        if a > t:
            break
        if t < b and (best_len is None or b - a < best_len):
            best, best_len = name, b - a
    return best


def _ns(ev, what):
    if hasattr(ev, f"{what}_ns"):
        return int(getattr(ev, f"{what}_ns")())
    return int(getattr(ev, f"{what}_us")() * 1000)


class Tracer:
    """A ``torch.profiler`` session over CPU and CUDA activity."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.prof = None
        self.trace: Trace | None = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.spans.marking = True
        with torch.profiler.record_function(PREFIX + "trace_start"):
            pass

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with torch.profiler.record_function(PREFIX + "trace_stop"):
            pass
        self.spans.marking = False
        self.prof.__exit__(None, None, None)
        self.trace = read(self.prof)
        self.prof = None

    @property
    def active(self) -> bool:
        return self.prof is not None


def read(prof) -> Trace:
    """The device intervals, the benchmark's spans and the host's outermost
    operations of a finished session; the stretch runs from the start
    marker to the stop marker."""
    device, spans, host, kernels = [], [], [], 0
    t0 = t1 = None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, "start")
        end = start + int(ev.duration_ns() if hasattr(ev, "duration_ns") else ev.duration_us() * 1000)
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith(PREFIX) or "annotation" in str(getattr(ev, "activity_type", lambda: "")()):
                continue  # a span's range on the device's timeline, not an operation
            device.append((name, start, end))
            if not (name.startswith("Memcpy") or name.startswith("Memset")):
                kernels += 1
        elif name.startswith(PREFIX):
            short = name[len(PREFIX):]
            if short == "trace_start":
                t0 = start
            elif short == "trace_stop":
                t1 = end
            else:
                spans.append((short, start, end))
        else:
            host.append((name, start, end))
    if t0 is None or t1 is None:
        raise RuntimeError("the trace holds no start or stop marker")
    return Trace(t0=t0, t1=t1, device=device, kernels=kernels, spans=spans, host=_outermost(host))


def _outermost(events):
    """The events that no other event encloses, in order of start."""
    out, end = [], None
    for name, a, b in sorted(events, key=lambda e: (e[1], -e[2])):
        if end is None or a >= end:
            out.append((name, a, b))
            end = b
        else:
            end = max(end, b)
    return out
