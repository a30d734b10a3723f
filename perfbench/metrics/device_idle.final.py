"""The share of the traced stretch with no operation running on the card."""

from perfbench.bench.readers import device_idle as read  # noqa: F401
