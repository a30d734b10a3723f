"""The candidates' frames over the cells that scoring dispatched (rows times
the window bucket W), over the traced calls."""

from perfbench.bench.program_trace import window_fill as read  # noqa: F401
