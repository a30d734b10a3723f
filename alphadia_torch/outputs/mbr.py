"""Match-between-runs library builder.

- the PSMs at ``qval <= fdr``; their targets define the elution groups
  kept (with their decoys only if ``keep_decoys``);
- each precursor's RT is the median observed RT of its
  ``mod_seq_charge_hash``, else of its elution group, else its library RT;
- ``proteins`` / ``genes`` become the elution group's inferred protein
  group;
- fragments are the base library's rows of each kept precursor.

``SearchPlanOutput`` writes it as ``speclib.mbr.hdf`` (``SpecLibFlat.save_hdf``),
which the search plan's MBR step loads.
"""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.library.speclib import SpecLibFlat
from alphadia_torch.reporting import PROGRESS
from alphadia_torch.utils.frame import take
from alphadia_torch.workflow.optimizers.optimization_lock import subset_flat_library

logger = logging.getLogger(__name__)


def _median_by(keys: np.ndarray, values: np.ndarray) -> dict:
    out = {}
    if len(keys):
        order = np.argsort(keys, kind="stable")
        k, v = keys[order], values[order].astype(np.float64)
        starts = np.r_[0, np.nonzero(k[1:] != k[:-1])[0] + 1]
        for a, b in zip(starts, np.r_[starts[1:], len(k)]):
            vals = v[a:b]
            vals = vals[~np.isnan(vals)]
            out[k[a].item()] = float(np.median(vals)) if len(vals) else np.nan
    return out


class MbrLibraryBuilder:
    def __init__(self, fdr: float = 0.01, keep_decoys: bool = True):
        self.fdr = fdr
        self.keep_decoys = keep_decoys

    def __call__(self, psm_df: dict, base_library: SpecLibFlat) -> SpecLibFlat:
        psm = take(psm_df, np.asarray(psm_df["qval"]) <= self.fdr) if "qval" in psm_df else psm_df
        targets = take(psm, np.asarray(psm["decoy"]) == 0) if "decoy" in psm else psm

        eg = np.asarray(targets["elution_group_idx"])
        rt_obs = np.asarray(targets["rt_observed"])
        rt_by_hash = _median_by(np.asarray(targets["mod_seq_charge_hash"]), rt_obs) if "mod_seq_charge_hash" in targets else {}
        rt_by_eg = _median_by(eg, rt_obs)
        pg_by_eg: dict = {}
        if "pg" in targets:
            for e, g in zip(eg.tolist(), targets["pg"]):
                if e not in pg_by_eg and g is not None and not (isinstance(g, float) and np.isnan(g)):
                    pg_by_eg[e] = g

        prec = base_library.precursor_df
        keep_eg = set(eg.tolist())
        mask = np.isin(prec["elution_group_idx"], list(keep_eg))
        if not self.keep_decoys:
            mask = mask & (np.asarray(prec["decoy"]) == 0)
        lib = subset_flat_library(prec, base_library.fragment_df, mask)
        out = lib.precursor_df

        out_eg = np.asarray(out["elution_group_idx"]).tolist()
        rt = np.full(len(out_eg), np.nan, np.float32)
        if rt_by_hash and "mod_seq_charge_hash" in out:
            rt = np.array([rt_by_hash.get(h, np.nan) for h in np.asarray(out["mod_seq_charge_hash"]).tolist()], np.float32)
        fallback = np.array([rt_by_eg.get(e, np.nan) for e in out_eg], np.float32)
        rt = np.where(np.isnan(rt), fallback, rt)
        out["rt_library"] = np.where(np.isnan(rt), np.asarray(out["rt_library"], np.float32), rt)

        if pg_by_eg:
            for col in ("proteins", "genes"):
                if col in out:
                    out[col] = np.array(
                        [str(pg_by_eg[e]) if e in pg_by_eg else v for e, v in zip(out_eg, out[col])], dtype=object
                    )

        logger.log(PROGRESS, f"MBR library: {len(out_eg)} precursors from {len(keep_eg)} confident elution groups")
        return SpecLibFlat(out, lib.fragment_df)
