"""The peptide-centric workflow's FDR feature set.

For now only ``FDR_FEATURE_COLUMNS``: the workflow class itself
(``PeptideCentricWorkflow``) comes with the workflow and CLI entry of the
port (ROADMAP queue 1, item 3).
"""

from __future__ import annotations

from alphadia_torch.search.scoring import FEATURE_COLUMNS

# the columns the FDR classifier reads: the 46 scoring features + derived
FDR_FEATURE_COLUMNS = FEATURE_COLUMNS + [
    "delta_rt",
    "score",
    "n_K",
    "n_R",
    "n_P",
    "charge",
    "nAA",
]
