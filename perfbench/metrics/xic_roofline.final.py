"""The XIC kernel's share of its roofline on the traced units (%)."""

from perfbench.bench.readers import xic_roofline as read  # noqa: F401
