"""Device kernels in the traced calls per 1,000 precursors."""

from perfbench.bench.readers import kernels_per_kprec as read  # noqa: F401
