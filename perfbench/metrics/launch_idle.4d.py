"""The share of the traced stretch in which the card idles while the host
enqueues work (the drivers' launch spans, the ops inside them included)."""

from perfbench.bench.program_trace import launch_idle as read  # noqa: F401
