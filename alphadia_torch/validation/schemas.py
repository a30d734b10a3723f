"""The frames' column contracts (names and dtypes as the JAX package's)."""

import numpy as np

from alphadia_torch.validation.base import Optional, Required, Schema

precursors_flat_schema = Schema(
    "precursors_flat",
    [
        Required("precursor_idx", np.uint32),
        Optional("elution_group_idx", np.uint32),
        Optional("channel", np.uint32),
        Optional("decoy", np.uint8),
        Required("flat_frag_start_idx", np.uint32),
        Required("flat_frag_stop_idx", np.uint32),
        Optional("charge", np.uint8),
        Required("rt_library", np.float32),
        Optional("rt_calibrated", np.float32),
        Optional("mobility_library", np.float32),
        Optional("mobility_calibrated", np.float32),
        Required("mz_library", np.float32),
        Optional("mz_calibrated", np.float32),
        Optional("proteins", object),
        Optional("genes", object),
        Optional("sequence", object),
        Optional("mods", object),
        Optional("mod_sites", object),
        *[Optional(f"i_{i}", np.float32) for i in range(10)],
    ],
)

fragments_flat_schema = Schema(
    "fragments_flat",
    [
        Required("mz_library", np.float32),
        Optional("mz_calibrated", np.float32),
        Required("intensity", np.float32),
        Optional("cardinality", np.uint8),
        Required("type", np.uint8),
        Optional("loss_type", np.uint8),
        Required("charge", np.uint8),
        Required("number", np.uint8),
        Required("position", np.uint8),
    ],
)

candidates_schema = Schema(
    "candidates",
    [
        Required("precursor_idx", np.int64),
        Optional("rank", np.uint8),
        Optional("score", np.float32),
        Required("scan_start", np.int64),
        Required("scan_center", np.int64),
        Required("scan_stop", np.int64),
        Required("frame_start", np.int64),
        Required("frame_center", np.int64),
        Required("frame_stop", np.int64),
    ],
)
