"""The flat spectral library, the search's input: a precursor and a
fragment column dict. ``flat_frag_start_idx`` / ``flat_frag_stop_idx`` of a
precursor delimit its fragment rows.

Only the container is ported here; the loaders, HDF I/O and hashing come
with the library slice of the port."""

from __future__ import annotations

from alphadia_torch.utils.frame import copy_frame, n_rows


class SpecLibFlat:
    def __init__(self, precursor_df: dict, fragment_df: dict):
        self.precursor_df = precursor_df
        self.fragment_df = fragment_df
        # set by the per-run library init: the frames before the run's
        # filter, which the multiplexing requant subsets again
        self.precursor_df_unfiltered: dict | None = None
        self.fragment_df_unfiltered: dict | None = None

    @property
    def n_precursors(self) -> int:
        return n_rows(self.precursor_df)

    def copy(self) -> "SpecLibFlat":
        return SpecLibFlat(copy_frame(self.precursor_df), copy_frame(self.fragment_df))
