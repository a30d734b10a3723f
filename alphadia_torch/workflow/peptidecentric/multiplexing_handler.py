"""Multiplexing requantification: the confident PSMs carried to every
channel of their elution group, rescored, and held to a channel FDR.

- ``multiplex_candidates``: the best reference-channel PSM of each
  confident elution group (lowest ``proba``, then ``precursor_idx``; the
  highest ``score`` where no ``proba``) donates its rank, score and
  scan/frame window to every channel sibling in the unfiltered library;
- ``channel_fdr``: q-values with the decoy channel as the null, over all
  target channels at once or per target channel (``channel_wise``); the
  decoy channel's rows get ``qval = 1.0`` there;
- ``MultiplexingHandler.requantify``: the run's calibration predicted onto
  the unfiltered library (every channel), the candidates' library cut from
  the unfiltered frames (their ``flat_frag_*`` address the original
  fragment table) and its fragments calibrated, scored on the device, the
  FDR manager's stored classifier, then ``channel_fdr``.

The JAX package's ``multiplexing_handler.py`` with column dicts for its
frames: its sorts stable, the same keys, the same row order. One change:
the JAX handler calibrates the unfiltered precursors but not their
fragments, so that its scoring asks for an ``mz_calibrated`` fragment
column that is not there once the run's fragment m/z calibration is
fitted; the port predicts the fragment calibration onto the candidates'
fragments.
"""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.fdr.qvalues import get_q_values, keep_best
from alphadia_torch.utils.frame import concat, copy_frame, lexsort_rows, n_rows, sort_rows_descending, take
from alphadia_torch.workflow.managers.calibration_manager import CalibrationGroups
from alphadia_torch.workflow.optimizers.optimization_lock import subset_flat_library

logger = logging.getLogger(__name__)

COORD_COLUMNS = [
    "rank", "score", "scan_start", "scan_center", "scan_stop", "frame_start", "frame_center", "frame_stop",
]


def multiplex_candidates(confident_psm: dict, unfiltered_precursor_df: dict, reference_channel: int = 0) -> dict:
    """Candidates (``precursor_idx``, ``elution_group_idx``, ``channel`` and
    the donor's coordinates) for every channel sibling of each confident
    elution group, in the unfiltered library's row order; ``{}`` without a
    confident reference-channel PSM."""
    ref = confident_psm
    if reference_channel >= 0 and "channel" in ref:
        ref = take(ref, ref["channel"] == reference_channel)
    if n_rows(ref) == 0:
        logger.warning("multiplexing: no confident reference-channel PSMs")
        return {}

    if "proba" in ref:
        order = lexsort_rows(ref, ["proba"] + (["precursor_idx"] if "precursor_idx" in ref else []))
    else:
        order = sort_rows_descending(ref, ["score"])
    ref = take(ref, order)
    _, first = np.unique(ref["elution_group_idx"], return_index=True)
    coords = take({c: ref[c] for c in ["elution_group_idx"] + COORD_COLUMNS}, np.sort(first))

    lib = unfiltered_precursor_df
    siblings = np.nonzero(np.isin(lib["elution_group_idx"], coords["elution_group_idx"]))[0]
    out = {c: lib[c][siblings] for c in ("precursor_idx", "elution_group_idx", "channel")}
    # the donor of each sibling's group (one per group: a left merge)
    by_group = np.argsort(coords["elution_group_idx"], kind="stable")
    donor = by_group[np.searchsorted(coords["elution_group_idx"][by_group], out["elution_group_idx"])]
    for c in COORD_COLUMNS:
        out[c] = coords[c][donor]
    out["rank"] = out["rank"].astype(np.uint8)
    logger.info(
        "multiplexing: expanded %d elution groups to %d channel candidates", n_rows(coords), n_rows(out)
    )
    return out


def channel_fdr(psm_df: dict, decoy_channel: int, target_channels: list[int], channel_wise: bool = False) -> dict:
    """q-values (``qval``) with the decoy channel as the null: one estimate
    over every channel, or one a target channel against the decoy channel
    (``fdr.channel_wise_fdr``); the best row of each (channel, elution
    group)."""
    psm_df = copy_frame(psm_df)
    psm_df["_decoy"] = (psm_df["channel"] == decoy_channel).astype(np.float32)
    groups = ["channel", "elution_group_idx"]
    if channel_wise:
        outs = []
        for c in target_channels:
            sub = take(psm_df, np.isin(psm_df["channel"], [c, decoy_channel]))
            if not n_rows(sub):
                continue
            sub = get_q_values(sub, "proba", "_decoy")
            sub = keep_best(sub, group_columns=groups)
            sub = get_q_values(sub, "proba", "_decoy")
            outs.append(take(sub, sub["channel"] == c))
        dec = take(psm_df, psm_df["channel"] == decoy_channel)
        if n_rows(dec):
            dec = keep_best(dec, group_columns=groups)
            dec["qval"] = np.ones(n_rows(dec))  # the null, never a discovery
            outs.append(dec)
        return concat(outs) if outs else take(psm_df, np.zeros(n_rows(psm_df), bool))
    psm_df = get_q_values(psm_df, "proba", "_decoy")
    psm_df = keep_best(psm_df, group_columns=groups)
    psm_df = get_q_values(psm_df, "proba", "_decoy")
    return take(psm_df, np.isin(psm_df["channel"], [*target_channels, decoy_channel]))


class MultiplexingHandler:
    def __init__(self, config, fdr_manager, extraction_handler, calibration_manager):
        self._config = config
        self._fdr_manager = fdr_manager
        self._handler = extraction_handler
        self._cm = calibration_manager

    def requantify(self, dia_data, spectral_library, psm_df: dict) -> tuple[dict, dict]:
        """(the channel PSMs with their q-values, their fragments); two
        empty frames without a confident reference-channel PSM."""
        mp = self._config["multiplexing"]
        target_channels = [int(c) for c in str(mp["target_channels"]).split(",")]

        unfiltered = copy_frame(getattr(spectral_library, "precursor_df_unfiltered", spectral_library.precursor_df))
        self._cm.predict(unfiltered, CalibrationGroups.PRECURSOR)

        confident = take(psm_df, psm_df["qval"] <= self._config["fdr"]["fdr"])
        candidates = multiplex_candidates(confident, unfiltered, mp["reference_channel"])
        if n_rows(candidates) == 0:
            return {}, {}

        # the unfiltered flat_frag_* address the original fragment table,
        # which the run's fragment calibration has not seen yet
        frag_unfiltered = getattr(spectral_library, "fragment_df_unfiltered", spectral_library.fragment_df)
        lib = subset_flat_library(unfiltered, frag_unfiltered, np.isin(unfiltered["precursor_idx"], candidates["precursor_idx"]))
        self._cm.predict(lib.fragment_df, CalibrationGroups.FRAGMENT)
        features, fragments = self._handler.score_and_quantify_candidates(
            {c: candidates[c] for c in ["precursor_idx"] + COORD_COLUMNS}, dia_data, lib
        )
        scored = self._fdr_manager.predict(features)
        out = channel_fdr(scored, mp["decoy_channel"], target_channels, channel_wise=self._config["fdr"]["channel_wise_fdr"])
        logger.log(
            25, "multiplexing requant: %d channel PSMs (%d at FDR)", n_rows(out),
            int((out["qval"] <= self._config["fdr"]["fdr"]).sum()) if n_rows(out) else 0,
        )
        return out, fragments
