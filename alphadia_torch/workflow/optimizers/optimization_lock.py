"""Optimization lock: elution-group batches that grow exponentially.

The elution groups are shuffled with a fixed seed (772), in the order of
their first appearance in the library, as pandas' ``unique`` gives them.
The batch plan doubles (1, 2, 4, ... x batch_size) over consecutive ranges;
features accumulate across batches until ``optimization_lock_target``
precursors pass 1% FDR; once reached, the lock extracts cumulatively from
index 0. After convergence ``reset_after_convergence`` keeps that
cumulative [0, stop_idx) slice, not the whole library: the whole library
is searched only in the final extraction.
"""

from __future__ import annotations

import numpy as np

from alphadia_torch.constants.settings import OPTLOCK_SHUFFLE_SEED
from alphadia_torch.library.speclib import SpecLibFlat
from alphadia_torch.utils.frame import concat, take, unique_in_order
from alphadia_torch.workflow.managers.calibration_manager import CalibrationGroups


def subset_flat_library(precursor_df: dict, fragment_df: dict, mask: np.ndarray) -> SpecLibFlat:
    """The precursors of ``mask`` with their fragment rows compacted."""
    prec = take(precursor_df, np.asarray(mask, bool))
    starts = prec["flat_frag_start_idx"].astype(np.int64)
    counts = prec["flat_frag_stop_idx"].astype(np.int64) - starts
    new_starts = np.zeros(len(starts), dtype=np.int64)
    if len(starts) > 1:
        np.cumsum(counts[:-1], out=new_starts[1:])
    # fragment row = start of its precursor + offset within it
    idx = np.repeat(starts - new_starts, counts) + np.arange(int(counts.sum()), dtype=np.int64)
    frag = take(fragment_df, idx)
    prec["flat_frag_start_idx"] = new_starts.astype(np.uint32)
    prec["flat_frag_stop_idx"] = (new_starts + counts).astype(np.uint32)
    return SpecLibFlat(prec, frag)


class OptimizationLock:
    def __init__(self, library: SpecLibFlat, config):
        self._library = library
        self.previously_calibrated = False
        self.has_target_num_precursors = False

        self._elution_group_order = unique_in_order(library.precursor_df["elution_group_idx"])
        rng = np.random.default_rng(seed=OPTLOCK_SHUFFLE_SEED)
        rng.shuffle(self._elution_group_order)

        self._precursor_target_count = config["calibration"]["optimization_lock_target"]
        self._batch_size = config["calibration"]["batch_size"]

        self.batch_idx = 0
        self.batch_plan = self._get_batch_plan(len(self._elution_group_order), self._batch_size)
        self.total_elution_groups = 0
        self._precursor_at_fdr_count = 0
        self.batch_library: SpecLibFlat | None = None
        self.set_batch_dfs()

        self._feature_dfs: list[dict] = []
        self._fragment_dfs: list[dict] = []

    @staticmethod
    def _get_batch_plan(num_items: int, batch_size: int) -> list[tuple[int, int]]:
        plan = []
        step = 0
        start_idx = 0
        stop_idx = 0
        while stop_idx < num_items:
            stop_idx = min(stop_idx + (2**step) * batch_size, num_items)
            plan.append((start_idx, stop_idx))
            step += 1
            start_idx = stop_idx
        return plan or [(0, 0)]

    @property
    def features_df(self) -> dict:
        return concat(self._feature_dfs) if self._feature_dfs else {}

    @property
    def fragments_df(self) -> dict:
        return concat(self._fragment_dfs) if self._fragment_dfs else {}

    @property
    def start_idx(self) -> int:
        if self.has_target_num_precursors:
            return 0
        if self.batch_idx >= len(self.batch_plan):
            raise IndexError("batch index out of bounds")
        return self.batch_plan[self.batch_idx][0]

    @property
    def stop_idx(self) -> int:
        return self.batch_plan[min(self.batch_idx, len(self.batch_plan) - 1)][1]

    def batches_remaining(self) -> bool:
        return self.batch_idx + 1 < len(self.batch_plan)

    def update_with_extraction(self, feature_df: dict, fragment_df: dict) -> None:
        self._feature_dfs.append(feature_df)
        self._fragment_dfs.append(fragment_df)
        groups = [f["elution_group_idx"] for f in self._feature_dfs if "elution_group_idx" in f]
        self.total_elution_groups = len(np.unique(np.concatenate(groups))) if groups else 0

    def update_with_fdr(self, precursor_df: dict) -> None:
        self._precursor_at_fdr_count = int(((precursor_df["qval"] <= 0.01) & (precursor_df["decoy"] == 0)).sum())
        self.has_target_num_precursors = self._precursor_at_fdr_count >= self._precursor_target_count

    def update_with_calibration(self, calibration_manager) -> None:
        calibration_manager.predict(self.batch_library.precursor_df, CalibrationGroups.PRECURSOR)
        calibration_manager.predict(self.batch_library.fragment_df, CalibrationGroups.FRAGMENT)

    def _decrease_batch_idx(self) -> None:
        """The smallest batch whose cumulative size should still yield the
        target count."""
        if self._precursor_at_fdr_count <= 0:
            self.batch_idx = 0
            return
        needed_stop = self.stop_idx * self._precursor_target_count / self._precursor_at_fdr_count
        diffs = np.array([stop - needed_stop for _, stop in self.batch_plan])
        ok = np.nonzero(diffs >= 0)[0]
        self.batch_idx = int(ok[0]) if len(ok) else len(self.batch_plan) - 1

    def update(self) -> None:
        if self.has_target_num_precursors:
            self._decrease_batch_idx()
            self._feature_dfs = []
            self._fragment_dfs = []
        else:
            self.batch_idx += 1
        self.set_batch_dfs()

    def reset_after_convergence(self, calibration_manager) -> None:
        self.has_target_num_precursors = True
        self._feature_dfs = []
        self._fragment_dfs = []
        self.set_batch_dfs()
        self.update_with_calibration(calibration_manager)

    def set_batch_dfs(self, eg_idxes=None) -> None:
        if eg_idxes is None:
            eg_idxes = self._elution_group_order[self.start_idx : self.stop_idx]
        mask = np.isin(self._library.precursor_df["elution_group_idx"], eg_idxes)
        self.batch_library = subset_flat_library(self._library.precursor_df, self._library.fragment_df, mask)
