"""Transfer-library requantification: the confident PSMs quantified again
over their whole fragment space.

``TransferRequantHandler.requantify(dia_data, psm_df)``:

- the precursors of the PSMs get every fragment of
  ``transfer_library.fragment_types`` up to ``transfer_library.max_charge``
  from their sequences (unit intensities, so flattening keeps them all);
- the run's calibration is predicted onto the new precursor and fragment
  rows;
- the scoring driver quantifies every fragment at the optimized
  tolerances: shared ions kept, unobserved fragments emitted as zeros, the
  fragment axis bucketed (``_bucket_topk``: 16-256) so that few shapes
  reach the device;
- the PSM rows get ``flat_frag_start_idx`` / ``flat_frag_stop_idx`` into the
  new fragment table, which is sorted by candidate (``candidate_hash``).

The scored top-12 set is too sparse to train the MS2 model on; this is
the transfer library's input. The JAX package's
``transfer_requant_handler.py`` with column dicts for its frames.
"""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.library.flatten import FlattenLibrary, InitFlatColumns
from alphadia_torch.library.speclib import SpecLibBase
from alphadia_torch.search.scoring import CandidateScoring, ScoringConfig
from alphadia_torch.utils.frame import n_rows, take
from alphadia_torch.utils.misc import candidate_hash
from alphadia_torch.workflow.managers.calibration_manager import CalibrationGroups

logger = logging.getLogger(__name__)

CANDIDATE_COLUMNS = (
    "precursor_idx", "rank", "score", "scan_center", "scan_start", "scan_stop", "frame_center", "frame_start",
    "frame_stop",
)


def _bucket_topk(n: int) -> int:
    """The fragment axis's width for ``n`` fragments: few shapes."""
    for b in (16, 32, 64, 128, 192, 256):
        if n <= b:
            return b
    return n


def _first_rows(frame: dict, key: np.ndarray) -> dict:
    """The first row of each ``key``, in row order (pandas'
    ``drop_duplicates``)."""
    _, first = np.unique(key, return_index=True)
    return take(frame, np.sort(first))


class TransferRequantHandler:
    def __init__(self, config, calibration_manager, optimization_manager, device=None, devices=None):
        self._config = config
        self._cm = calibration_manager
        self._om = optimization_manager
        # the scoring driver splits its chunks across all of ``devices`` (the
        # JAX handler's ScoringConfig sets no mesh cap either)
        self.device = device
        self.devices = devices

    def requantify(self, dia_data, psm_df: dict) -> tuple[dict, dict]:
        """(the PSM rows, one a candidate, with ``flat_frag_{start,stop}_idx``
        into the new table; the fragments quantified over the whole
        fragment space)."""
        logger.log(25, "=== Transfer learning quantification ===")
        types = tuple(self._config["transfer_library"]["fragment_types"])
        max_charge = int(self._config["transfer_library"]["max_charge"])
        logger.info("transfer requant: fragment types %s up to charge %d", types, max_charge)

        scored = _first_rows(psm_df, candidate_hash(psm_df["precursor_idx"], psm_df["rank"]))
        prec = _first_rows(scored, np.asarray(scored["precursor_idx"]))

        lib = SpecLibBase(prec)
        lib.calc_fragment_mz(max_charge=max_charge, types=types)
        lib.fragment_intensity = np.ones_like(lib.fragment_mz, dtype=np.float32)
        flat = InitFlatColumns()(FlattenLibrary(top_k_fragments=10**6, min_fragment_intensity=0.0)(lib))
        fprec, ffrag = flat.precursor_df, flat.fragment_df

        self._cm.predict(fprec, CalibrationGroups.PRECURSOR)
        self._cm.predict(ffrag, CalibrationGroups.FRAGMENT)

        n_frag_max = int((fprec["flat_frag_stop_idx"].astype(np.int64) - fprec["flat_frag_start_idx"]).max())
        scoring = CandidateScoring(
            dia_data,
            fprec,
            ffrag,
            ScoringConfig(
                precursor_mz_tolerance=self._om.ms1_error,
                fragment_mz_tolerance=self._om.ms2_error,
                top_k_fragments=_bucket_topk(n_frag_max),
                exclude_shared_ions=False,
                collect_fragments=True,
                collect_unobserved_fragments=True,
                batch_size=self._config["tpu"]["scoring_batch"],
            ),
            rt_column="rt_library",
            precursor_mz_column="mz_calibrated" if "mz_calibrated" in fprec else "mz_library",
            fragment_mz_column="mz_calibrated" if "mz_calibrated" in ffrag else "mz_library",
            device=self.device,
            devices=self.devices,
        )
        _, frag_df = scoring({c: scored[c] for c in CANDIDATE_COLUMNS if c in scored})
        logger.log(25, "transfer requant: %s precursors -> %s fragments quantified",
                   f"{n_rows(scored):,}", f"{n_rows(frag_df):,}")

        # the PSM rows onto the new fragment table, sorted by candidate
        scored = dict(scored)
        scored["_candidate_idx"] = candidate_hash(scored["precursor_idx"], scored["rank"])
        frag_df = dict(frag_df)
        frag_df["_candidate_idx"] = candidate_hash(frag_df["precursor_idx"], frag_df["rank"])
        frag_df = take(frag_df, np.argsort(frag_df["_candidate_idx"], kind="stable"))
        keys, counts = np.unique(frag_df["_candidate_idx"], return_counts=True)
        stop = np.cumsum(counts)
        start = stop - counts
        scored = take(scored, np.argsort(scored["_candidate_idx"], kind="stable"))
        pos = np.searchsorted(keys, scored["_candidate_idx"])
        found = pos < len(keys)
        found[found] = keys[pos[found]] == scored["_candidate_idx"][found]
        for name, bound in (("flat_frag_start_idx", start), ("flat_frag_stop_idx", stop)):
            scored[name] = np.zeros(n_rows(scored), np.int64)  # a candidate without fragments: 0, 0
            scored[name][found] = bound[pos[found]]
        return scored, frag_df
