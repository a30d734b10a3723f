"""Flatten a hierarchical library into the search's input:
``FlattenLibrary``, ``InitFlatColumns``, ``LogFlatLibraryStats``.

Each precursor keeps its ``top_k`` most intense fragments above a minimum
share of its most intense one, sorted by m/z within the precursor's block;
the flat fragment columns are mz_library f32, intensity f32, cardinality
u8, type u8, loss_type u8, charge u8, number u8, position u8. The JAX
package's ``library/flatten.py`` on column dicts.
"""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.library.pipeline import ProcessingStep
from alphadia_torch.library.speclib import SpecLibBase, SpecLibFlat
from alphadia_torch.utils.frame import copy_frame, n_rows, rename

logger = logging.getLogger(__name__)


class FlattenLibrary(ProcessingStep):
    def __init__(self, top_k_fragments: int = 12, min_fragment_intensity: float = 0.01):
        self.top_k_fragments = top_k_fragments
        self.min_fragment_intensity = min_fragment_intensity

    def validate(self, input_) -> bool:
        return isinstance(input_, SpecLibBase) and input_.fragment_mz is not None

    def forward(self, lib: SpecLibBase) -> SpecLibFlat:
        prec = copy_frame(lib.precursor_df)
        cols = lib.charged_frag_types
        mz_mat = lib.fragment_mz.astype(np.float32)
        int_mat = lib.fragment_intensity.astype(np.float32) if lib.fragment_intensity is not None else np.ones_like(mz_mat)

        type_code = np.array([ord(c.split("_z")[0][0]) for c in cols], dtype=np.uint8)
        frag_charge = np.array([int(c.split("_z")[1]) for c in cols], dtype=np.uint8)
        is_nterm = np.array([c.split("_z")[0][0] in "abc" for c in cols], dtype=bool)

        starts = prec["frag_start_idx"]
        stops = prec["frag_stop_idx"]
        naa = prec["nAA"]
        n = n_rows(prec)

        parts = {k: [] for k in ("mz", "int", "type", "charge", "number", "position")}
        flat_start = np.zeros(n, dtype=np.uint32)
        flat_stop = np.zeros(n, dtype=np.uint32)
        cursor = 0
        for i in range(n):
            a, b = starts[i], stops[i]
            n_sites = b - a
            pos = np.repeat(np.arange(n_sites, dtype=np.int32), len(cols))
            mzf = mz_mat[a:b].ravel()
            intf = int_mat[a:b].ravel()
            number = np.where(np.tile(is_nterm, n_sites), pos + 1, naa[i] - 1 - pos)

            mmax = intf.max() if len(intf) else 0.0
            keep = (mzf > 10.0) & (intf >= self.min_fragment_intensity * max(mmax, 1e-12))
            idx = np.nonzero(keep)[0]
            if len(idx) > self.top_k_fragments:
                top = np.argsort(intf[idx], kind="stable")[::-1][: self.top_k_fragments]
                idx = idx[top]
            idx = idx[np.argsort(mzf[idx], kind="stable")]

            flat_start[i] = cursor
            cursor += len(idx)
            flat_stop[i] = cursor
            parts["mz"].append(mzf[idx])
            parts["int"].append(intf[idx])
            parts["type"].append(np.tile(type_code, n_sites)[idx])
            parts["charge"].append(np.tile(frag_charge, n_sites)[idx])
            parts["number"].append(number[idx])
            parts["position"].append(pos[idx])

        def cat(key, dtype):
            return np.concatenate(parts[key]).astype(dtype) if parts[key] else np.zeros(0, dtype)

        fragment_df = {
            "mz_library": cat("mz", np.float32),
            "intensity": cat("int", np.float32),
            "cardinality": np.ones(cursor, dtype=np.uint8),
            "type": cat("type", np.uint8),
            "loss_type": np.zeros(cursor, dtype=np.uint8),
            "charge": cat("charge", np.uint8),
            "number": cat("number", np.uint8),
            "position": cat("position", np.uint8),
        }
        prec["flat_frag_start_idx"] = flat_start
        prec["flat_frag_stop_idx"] = flat_stop
        flat = SpecLibFlat(prec, fragment_df)
        _compute_cardinality(flat)
        return flat


def _compute_cardinality(flat: SpecLibFlat) -> None:
    """cardinality = the precursors of one elution group that share a
    fragment m/z (to 1e-4)."""
    prec = flat.precursor_df
    frag = flat.fragment_df
    if "elution_group_idx" not in prec or n_rows(frag) == 0:
        return
    counts = (prec["flat_frag_stop_idx"].astype(np.int64) - prec["flat_frag_start_idx"].astype(np.int64))
    eg_of_frag = np.zeros(n_rows(frag), dtype=np.int64)
    rows = np.repeat(prec["flat_frag_start_idx"].astype(np.int64), counts) + (
        np.arange(int(counts.sum())) - np.repeat(np.cumsum(counts) - counts, counts)
    )
    eg_of_frag[rows] = np.repeat(prec["elution_group_idx"].astype(np.int64), counts)
    key = eg_of_frag * (1 << 32) + np.round(frag["mz_library"] * 1e4).astype(np.int64) % (1 << 32)
    _, inv, n_same = np.unique(key, return_inverse=True, return_counts=True)
    frag["cardinality"] = np.minimum(n_same[inv.reshape(-1)], 255).astype(np.uint8)


class InitFlatColumns(ProcessingStep):
    """The first matching coordinate column of each kind under its
    canonical ``*_library`` name."""

    PRECURSOR = {
        "mz_library": ["mz_library", "mz", "precursor_mz"],
        "rt_library": ["rt_library", "rt", "rt_norm", "rt_pred", "rt_norm_pred", "irt"],
        "mobility_library": ["mobility_library", "mobility", "mobility_pred"],
    }
    FRAGMENT = {"mz_library": ["mz_library", "mz", "predicted_mz"]}

    def validate(self, input_) -> bool:
        return isinstance(input_, SpecLibFlat)

    def forward(self, flat: SpecLibFlat) -> SpecLibFlat:
        for mapping, attr in ((self.PRECURSOR, "precursor_df"), (self.FRAGMENT, "fragment_df")):
            df = getattr(flat, attr)
            for target, candidates in mapping.items():
                found = next((c for c in candidates if c in df), None)
                if found is not None and found != target:
                    df = rename(df, {found: target})
            setattr(flat, attr, df)
        if "mobility_library" not in flat.precursor_df:
            flat.precursor_df["mobility_library"] = np.zeros(n_rows(flat.precursor_df), np.float32)
            logger.warning("Library contains no ion mobility annotations")
        return flat


class LogFlatLibraryStats(ProcessingStep):
    def validate(self, input_) -> bool:
        return isinstance(input_, SpecLibFlat)

    def forward(self, flat: SpecLibFlat) -> SpecLibFlat:
        df = flat.precursor_df
        logger.info("============ Library Stats ============")
        logger.info("Number of precursors: %s", f"{n_rows(df):,}")
        if "decoy" in df:
            logger.info("\tthereof targets: %s", f"{int((df['decoy'] == 0).sum()):,}")
            logger.info("\tthereof decoys: %s", f"{int((df['decoy'] == 1).sum()):,}")
        if "elution_group_idx" in df:
            logger.info("Number of elution groups: %s", f"{len(np.unique(df['elution_group_idx'])):,}")
        return flat
