"""The card's stream seconds inside the plain 4D extractions (extract_xic_4d,
extract_scan_profile) over the traced stretch's seconds."""

from perfbench.bench.program_trace import plain_xic_share as read  # noqa: F401
