"""What the program's own spans and counters give the per-layer metrics,
read beside the traced stretch (``run.trace``).

The program (``alphadia_torch.utils.profiling``) marks its drivers' phases
with profiler ranges ``alphadia_torch.<span>``, which the trace holds among
the host's outermost operations (``Trace.host``) on the clock of its device
intervals. Its device spans' stream seconds and its counters it records
while a profiler session is active, which is the traced stretch alone;
``program(run)`` takes them once a run and keeps them on it. Each reader
returns None where the run holds nothing to read: an untraced run, or a
program that marks no spans or records no counters.
"""

from __future__ import annotations

SPAN_PREFIX = "alphadia_torch."
# the spans of the drivers' host work, and those that enqueue work on the card
PREP = frozenset({"selection.prepare", "selection.decode", "scoring.library", "scoring.geometry", "scoring.assemble"})
LAUNCH = frozenset({"selection.launch", "scoring.launch"})
# the plain 4D extractions: spans with a pair of events on the card's stream
PLAIN_XIC = frozenset({"ops.xic_4d", "ops.scan_profile"})


def program(run):
    """``(device seconds by span, counters)`` that the program recorded over
    the traced calls, or None where the run was not traced or the program
    records neither."""
    if run.trace is None:
        return None
    if not hasattr(run, "program"):
        try:
            from alphadia_torch.utils import profiling
        except ImportError:
            profiling = None
        take = getattr(profiling, "take", None)
        run.program = take() if take is not None else None
    return run.program


def _overlap(xs, ys) -> int:
    """The length of the intersection of two lists of sorted disjoint
    intervals."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        total += max(hi - lo, 0)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in(run, names):
    """Seconds of the traced stretch with no device operation running while
    the host is inside a span named in ``names`` (children included), over
    the stretch's seconds."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    # outermost operations: disjoint, in order of start
    spans = [
        (max(a, tr.t0), min(b, tr.t1)) for name, a, b in tr.host
        if name.startswith(SPAN_PREFIX) and name[len(SPAN_PREFIX):] in names
    ]
    spans = [(a, b) for a, b in spans if b > a]
    if not spans:
        return None
    return _overlap(spans, tr.idle_gaps()) * 1e-9 / tr.window_s


def prep_idle(run):
    return idle_in(run, PREP)


def launch_idle(run):
    return idle_in(run, LAUNCH)


def window_fill(run):
    """The candidates' frames over the cells that scoring dispatched (rows
    times the window bucket W)."""
    got = program(run)
    if got is None or not got[1].get("scoring.cells"):
        return None
    return got[1].get("scoring.extent_cells", 0) / got[1]["scoring.cells"]


def plain_xic_share(run):
    """Seconds of the card's stream inside the plain 4D extractions' spans
    (between their event pairs) over the stretch's seconds."""
    got = program(run)
    if got is None or run.trace.window_s <= 0:
        return None
    times = [s for name, s in got[0].items() if name in PLAIN_XIC]
    if not times:
        return None
    return sum(times) / run.trace.window_s
