"""The share of the traced stretch in which the card idles while the host
prepares or harvests work in the extraction drivers (their prep spans)."""

from perfbench.bench.program_trace import prep_idle as read  # noqa: F401
