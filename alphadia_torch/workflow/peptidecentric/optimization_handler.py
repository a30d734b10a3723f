"""The optimization and calibration loop.

- targeted optimizers (target tolerance > 0) run together first, then the
  automatic ones one after the other in the order ms2 -> rt -> ms1 ->
  mobility (or the order the config gives);
- per step: extract the lock's batch (pipelined selection and scoring),
  fit the FDR network; grow the batch until the lock's target is reached;
  then recalibrate: the first time only the classifier version is taken,
  afterwards the optimizers step;
- ``_filter_dfs``: precursors with qval < 0.01 that are targets; the
  fragments of those precursors with |mass_error| <= 200 ppm, sorted by
  correlation and precursor_idx descending as pandas sorts (NaN last, ties
  in their order), the first max(#above min_correlation, min(500, n)) of
  them, at most max_fragments.

``step_log`` keeps one record per step: the optimizers, their parameters
before and after the step, the batch (elution groups, precursors), the
targets at 1% FDR, the classifier version, and the walls of the step, of its
extraction and of its FDR fit.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

import numpy as np

from alphadia_torch.constants.settings import MAX_FRAGMENT_MZ_TOLERANCE
from alphadia_torch.utils.frame import n_rows, sort_rows_descending, take
from alphadia_torch.workflow.optimizers.automatic import (
    AutomaticMobilityOptimizer,
    AutomaticMS1Optimizer,
    AutomaticMS2Optimizer,
    AutomaticRTOptimizer,
)
from alphadia_torch.workflow.optimizers.optimization_lock import OptimizationLock
from alphadia_torch.workflow.optimizers.targeted import (
    TargetedMobilityOptimizer,
    TargetedMS1Optimizer,
    TargetedMS2Optimizer,
    TargetedRTOptimizer,
)
from alphadia_torch.workflow.peptidecentric.column_name_handler import ColumnNameHandler
from alphadia_torch.workflow.peptidecentric.extraction_handler import ExtractionHandler
from alphadia_torch.workflow.peptidecentric.recalibration_handler import RecalibrationHandler

logger = logging.getLogger(__name__)

_AUTOMATIC = {
    "ms2_error": AutomaticMS2Optimizer,
    "rt_error": AutomaticRTOptimizer,
    "ms1_error": AutomaticMS1Optimizer,
    "mobility_error": AutomaticMobilityOptimizer,
}
_TARGETED = {
    "ms2_error": TargetedMS2Optimizer,
    "rt_error": TargetedRTOptimizer,
    "ms1_error": TargetedMS1Optimizer,
    "mobility_error": TargetedMobilityOptimizer,
}
_DEFAULT_AUTOMATIC_ORDER = ["ms2_error", "rt_error", "ms1_error", "mobility_error"]


class OptimizationHandler:
    def __init__(self, config, optimization_manager, calibration_manager, fdr_manager, dia_data, library, device=None):
        self._config = config
        self._om = optimization_manager
        self._cm = calibration_manager
        self._fdr_manager = fdr_manager
        self._dia_data = dia_data
        self._optlock = OptimizationLock(library, config)
        self._device = device
        self.ordered_optimizers: list[list] = []
        self.step_log: list[dict] = []
        self._step: dict | None = None
        # set when the lock ran out of batches before reaching its target
        self.insufficient_precursors = False

    def _targets(self) -> dict:
        search = self._config["search"]
        return {
            "ms2_error": search["target_ms2_tolerance"],
            "ms1_error": search["target_ms1_tolerance"],
            "rt_error": search["target_rt_tolerance"],
            "mobility_error": search["target_mobility_tolerance"],
        }

    def _make_optimizer(self, name: str, targeted: bool):
        gradient = self._dia_data.rt_max - self._dia_data.rt_min
        initial = getattr(self._om, name)
        target = self._targets()[name]
        if name == "rt_error" and 0 < target <= 1:
            target = target * gradient
        if targeted:
            return _TARGETED[name](initial, target, self._config, self._om, self._cm, self._fdr_manager)
        return _AUTOMATIC[name](initial, self._config, self._om, self._cm, self._fdr_manager, self._optlock)

    def _get_ordered_optimizers(self):
        """Targeted ones (target > 0) first as one group, then the automatic
        ones one after the other."""
        targets = self._targets()
        names = list(_DEFAULT_AUTOMATIC_ORDER)
        if not self._dia_data.has_ms1:
            names.remove("ms1_error")
        if not self._dia_data.has_mobility:
            names.remove("mobility_error")

        order_cfg = self._config["optimization"]["order_of_optimization"]
        if order_cfg:
            groups = [[n for n in grp if n in names] for grp in order_cfg]
            return [[self._make_optimizer(n, targets[n] > 0) for n in grp] for grp in groups if grp]

        targeted = [n for n in names if targets[n] > 0]
        automatic = [n for n in names if targets[n] <= 0]
        ordered = []
        if targeted:
            ordered.append([self._make_optimizer(n, True) for n in targeted])
        for n in automatic:
            ordered.append([self._make_optimizer(n, False)])
        return ordered

    def search_parameter_optimization(self) -> None:
        ordered_optimizers = self.ordered_optimizers = self._get_ordered_optimizers()
        recal = RecalibrationHandler(self._config, self._om, self._cm)
        insufficient = False
        precursor_df: dict = {}
        max_steps = self._config["calibration"]["max_steps"]

        for optimizers in ordered_optimizers:
            if insufficient:
                break
            for step in range(max_steps):
                if all(o.has_converged for o in optimizers):
                    logger.log(25, "Optimization finished for %s", ", ".join(o.parameter_name for o in optimizers))
                    self._optlock.reset_after_convergence(self._cm)
                    break

                logger.info("Optimization step %d", step)
                with self._logged_step(optimizers):
                    precursor_df = self._process_batch()

                    if not self._optlock.has_target_num_precursors:
                        if not self._optlock.batches_remaining():
                            logger.warning("Insufficient precursors to continue optimization")
                            insufficient = self.insufficient_precursors = True
                            break
                        self._optlock.update()
                        if self._optlock.previously_calibrated:
                            self._optlock.update_with_calibration(self._cm)
                            for o in optimizers:
                                o.skip()
                    else:
                        prec_filtered, frag_filtered = self._filter_dfs(precursor_df, self._optlock.fragments_df)
                        self._optlock.update()
                        recal.recalibrate(prec_filtered, frag_filtered)
                        self._optlock.update_with_calibration(self._cm)
                        if not self._optlock.previously_calibrated:
                            self._optlock.previously_calibrated = True
                            self._om.update(classifier_version=self._fdr_manager.current_version)
                            continue
                        for o in optimizers:
                            o.step(prec_filtered, frag_filtered)
            else:
                logger.warning("Optimization did not converge within %d steps", max_steps)

        if insufficient and n_rows(precursor_df):
            prec_filtered, frag_filtered = self._filter_dfs(precursor_df, self._optlock.fragments_df)
            if n_rows(prec_filtered) >= 6:
                recal.recalibrate(prec_filtered, frag_filtered)
                # the cutoff was learned from scores standardised over the
                # current (wide) RT window, where the same peak scores
                # higher than at the target tolerance: a cutoff from an
                # optimization that never converged starves the extraction,
                # so the FDR does the filtering
                self._om.update(score_cutoff=0.0)
            for optimizers in ordered_optimizers:
                for o in optimizers:
                    o.proceed_with_insufficient_precursors(prec_filtered, self._optlock.fragments_df)

        for optimizers in ordered_optimizers:
            for o in optimizers:
                logger.log(25, "%-15s: %.4f", o.parameter_name, getattr(self._om, o.parameter_name))

    @contextmanager
    def _logged_step(self, optimizers):
        names = [o.parameter_name for o in optimizers]
        rec = {"optimizers": names, "before": {n: float(getattr(self._om, n)) for n in names}}
        self._step = rec
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec["wall"] = time.perf_counter() - t0
            rec["after"] = {n: float(getattr(self._om, n)) for n in names}
            rec["converged"] = [o.parameter_name for o in optimizers if o.has_converged]
            self.step_log.append(rec)
            self._step = None

    def _process_batch(self) -> dict:
        logger.log(25, "=== Extracting elution groups %d to %d ===", self._optlock.start_idx, self._optlock.stop_idx)
        rec = self._step if self._step is not None else {}
        rec.update(elution_groups=(self._optlock.start_idx, self._optlock.stop_idx), precursors=self._optlock.batch_library.n_precursors)
        t0 = time.perf_counter()
        handler = ExtractionHandler.create_handler(
            self._config,
            self._om,
            ColumnNameHandler(
                self._cm, dia_data_has_ms1=self._dia_data.has_ms1, dia_data_has_mobility=self._dia_data.has_mobility
            ),
            device=self._device,
        )
        _, features, fragments = handler.select_and_score(self._dia_data, self._optlock.batch_library)
        rec["extraction_wall"] = time.perf_counter() - t0
        self._optlock.update_with_extraction(features, fragments)
        t0 = time.perf_counter()

        compete = self._config["search"]["compete_for_fragments"]
        precursor_df = self._fdr_manager.fit_predict(
            self._optlock.features_df,
            decoy_strategy="precursor",
            competitive=self._config["fdr"]["competitive_scoring"],
            df_fragments=self._optlock.fragments_df if compete else None,
            version=self._om.classifier_version,
        )
        rec["fdr_wall"] = time.perf_counter() - t0
        self._optlock.update_with_fdr(precursor_df)
        n_pass = int(((precursor_df["qval"] <= 0.01) & (precursor_df["decoy"] == 0)).sum())
        rec.update(targets_at_1pct=n_pass, classifier_version=self._fdr_manager.current_version)
        logger.log(25, "=== %d target precursors at 1%% FDR ===", n_pass)
        return precursor_df

    def _filter_dfs(self, precursor_df: dict, fragments_df: dict) -> tuple[dict, dict]:
        prec = take(precursor_df, (precursor_df["qval"] < 0.01) & (precursor_df["decoy"] == 0))
        if n_rows(fragments_df) == 0:
            return prec, fragments_df
        keep = np.isin(fragments_df["precursor_idx"], prec["precursor_idx"]) & (
            np.abs(fragments_df["mass_error"]) <= MAX_FRAGMENT_MZ_TOLERANCE
        )
        frag = take(fragments_df, keep)
        frag = take(frag, sort_rows_descending(frag, ["correlation", "precursor_idx"]))
        n = n_rows(frag)
        high_corr = int((frag["correlation"] > self._config["calibration"]["min_correlation"]).sum())
        stop = min(max(high_corr, min(500, n)), self._config["calibration"]["max_fragments"])
        return prec, take(frag, slice(0, stop))
