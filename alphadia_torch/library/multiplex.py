"""Non-isobaric library multiplexing (dimethyl, mTRAQ and the like).

``MultiplexLibrary(multiplex_mapping, input_channel)(lib)``: the precursors
of the input channel, copied once per ``multiplex_mapping`` entry
(``{"channel_name": 4, "modifications": {"Dimethyl@K": "Dimethyl:2H(4)@K"}}``)
with ``channel`` set and the modifications translated by the entry's
mapping; each copy's precursor and fragment m/z computed anew from its
modifications (the fragment types and largest charge of the input's
``charged_frag_types``). The copies keep their source's elution group, so
the channels of one peptide compete downstream; the rows are sorted stably
by (``elution_group_idx``, ``channel``) and ``precursor_idx`` numbered anew.

The JAX package's ``library/multiplex.py`` with column dicts for its frames.
"""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.library.pipeline import ProcessingStep
from alphadia_torch.library.speclib import SpecLibBase
from alphadia_torch.utils.frame import copy_frame, lexsort_rows, n_rows, take

logger = logging.getLogger(__name__)


def _translate_mods(mods: str, mapping: dict[str, str]) -> str:
    if not mods:
        return mods
    return ";".join(mapping.get(m, m) for m in str(mods).split(";"))


class MultiplexLibrary(ProcessingStep):
    def __init__(self, multiplex_mapping: list[dict], input_channel: int = 0):
        self.multiplex_mapping = multiplex_mapping or []
        self.input_channel = input_channel

    def validate(self, input_) -> bool:
        return isinstance(input_, SpecLibBase) and len(self.multiplex_mapping) > 0

    def forward(self, lib: SpecLibBase) -> SpecLibBase:
        source = lib.precursor_df
        if "channel" in source:
            source = take(source, source["channel"] == self.input_channel)
        if not n_rows(source):
            raise ValueError(f"no precursors in input channel {self.input_channel}")

        base = SpecLibBase(copy_frame(source), lib.fragment_mz, lib.fragment_intensity, lib.charged_frag_types)
        types = tuple(sorted({c.split("_z")[0] for c in lib.charged_frag_types})) or ("b", "y")
        max_z = max((int(c.split("_z")[1]) for c in lib.charged_frag_types), default=2)
        channels = []
        for entry in self.multiplex_mapping:
            mapping = entry.get("modifications", {})
            chan = base.copy()
            df = chan.precursor_df
            df["channel"] = np.full(n_rows(df), int(entry["channel_name"]), np.uint32)
            df["mods"] = np.array([_translate_mods(m, mapping) for m in df["mods"]], dtype=object)
            chan.calc_precursor_mz()
            chan.calc_fragment_mz(max_charge=max_z, types=types)
            channels.append(chan)

        out = channels[0]
        for chan in channels[1:]:
            out.append(chan)
        out.precursor_df = take(out.precursor_df, lexsort_rows(out.precursor_df, ["elution_group_idx", "channel"]))
        out.precursor_df["precursor_idx"] = np.arange(n_rows(out.precursor_df), dtype=np.uint32)
        logger.log(
            25, "Multiplexed library: %d channels, %d precursors", len(self.multiplex_mapping), n_rows(out.precursor_df)
        )
        return out
