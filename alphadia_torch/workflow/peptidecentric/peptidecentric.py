"""The per-raw-file peptide-centric workflow.

``load`` (raw file -> ``DiaData``, the managers, the FDR manager, the
run's library), ``search_parameter_optimization`` (the calibration and
tolerance loop, then the final calibration applied to the whole library),
``extraction`` (the whole library at the optimized tolerances, PSMs at the
configured FDR), and the two requants after it: ``requantify`` (the
multiplexing handler: the confident PSMs in every channel, channel FDR)
and ``requantify_fragments`` (the transfer requant over the whole fragment
space). The device (``None``: the card) is handed down to the FDR manager,
and the device list (``devices``, default that one device) to the drivers,
which split their batches across it.
"""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.exceptions import NoPsmFoundError
from alphadia_torch.models.classifier import BinaryClassifier
from alphadia_torch.search.scoring import FEATURE_COLUMNS
from alphadia_torch.utils.frame import n_rows, take
from alphadia_torch.utils.misc import candidate_hash
from alphadia_torch.workflow.base import WorkflowBase
from alphadia_torch.workflow.managers.calibration_manager import CalibrationGroups
from alphadia_torch.workflow.managers.fdr_manager import FDRManager
from alphadia_torch.workflow.managers.timing_manager import use_timing_manager
from alphadia_torch.workflow.peptidecentric.column_name_handler import ColumnNameHandler
from alphadia_torch.workflow.peptidecentric.extraction_handler import ExtractionHandler
from alphadia_torch.workflow.peptidecentric.library_init import init_spectral_library
from alphadia_torch.workflow.peptidecentric.multiplexing_handler import MultiplexingHandler
from alphadia_torch.workflow.peptidecentric.optimization_handler import OptimizationHandler
from alphadia_torch.workflow.peptidecentric.transfer_requant_handler import TransferRequantHandler

logger = logging.getLogger(__name__)

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


class PeptideCentricWorkflow(WorkflowBase):
    def __init__(
        self,
        instance_name: str,
        config,
        quant_path: str | None = None,
        random_state: int | None = None,
        device=None,
        devices=None,
    ):
        super().__init__(instance_name, config, quant_path, device=device, devices=devices)
        self.fdr_manager: FDRManager | None = None
        self.optimization_handler: OptimizationHandler | None = None
        # the per-file seed a search derives from general.random_state
        self._random_state = random_state

    @use_timing_manager("load")
    def load(self, raw_path: str, spectral_library) -> None:
        self.reporter.log_event("load", "start")
        super().load(raw_path, spectral_library)

        random_state = self._random_state if self._random_state is not None else self.config["general"]["random_state"]
        classifier = BinaryClassifier(
            test_size=0.001,
            batch_size=5000,
            learning_rate=0.001,
            epochs=10,
            experimental_hyperparameter_tuning=self.config["fdr"]["enable_nn_hyperparameter_tuning"],
            random_state=random_state,
            device=self.device,
        )
        # each FDR fit draws the run's fdr.png again: it ends with the final extraction's
        figure_path = None
        if self.config["general"]["save_figures"]:
            figure_path = str(self.path / "figures" / "fdr.png")
            (self.path / "figures").mkdir(exist_ok=True)
        self.fdr_manager = FDRManager(
            feature_columns=FDR_FEATURE_COLUMNS,
            classifier_base=classifier,
            dia_cycle=self.dia_data.cycle,
            config=self.config,
            random_state=random_state,
            figure_path=figure_path,
            device=self.device,
        )
        self.spectral_library = init_spectral_library(
            self.dia_data.cycle,
            self.dia_data.cycle_rt,
            spectral_library,
            channel_filter=self.config["search"]["channel_filter"],
        )
        self.optimization_handler = OptimizationHandler(
            self.config,
            self.optimization_manager,
            self.calibration_manager,
            self.fdr_manager,
            self.dia_data,
            self.spectral_library,
            devices=self.devices,
        )

    @use_timing_manager("optimization")
    def search_parameter_optimization(self) -> None:
        self.optimization_handler.search_parameter_optimization()
        # the final calibration, applied to the whole library
        self.calibration_manager.predict(self.spectral_library.precursor_df, CalibrationGroups.PRECURSOR)
        self.calibration_manager.predict(self.spectral_library.fragment_df, CalibrationGroups.FRAGMENT)
        self.calibration_manager.save()
        self.optimization_manager.save()

    def _extraction_handler(self) -> ExtractionHandler:
        return ExtractionHandler.create_handler(
            self.config,
            self.optimization_manager,
            ColumnNameHandler(
                self.calibration_manager,
                dia_data_has_ms1=self.dia_data.has_ms1,
                dia_data_has_mobility=self.dia_data.has_mobility,
            ),
            devices=self.devices,
        )

    @use_timing_manager("extraction")
    def extraction(self) -> tuple[dict, dict]:
        """The whole library at the optimized parameters: (PSMs at the
        configured FDR, the fragments of the PSMs that survive)."""
        self.optimization_manager.update(num_candidates=self.config["search"]["target_num_candidates"])
        handler = self._extraction_handler()
        candidates = handler.select_candidates(self.dia_data, self.spectral_library, apply_cutoff=True)
        features, fragments = handler.score_and_quantify_candidates(candidates, self.dia_data, self.spectral_library)
        if n_rows(features) == 0:
            raise NoPsmFoundError()

        psm = self.fdr_manager.fit_predict(
            features,
            decoy_strategy="precursor",
            competitive=self.config["fdr"]["competitive_scoring"],
            df_fragments=fragments if self.config["search"]["compete_for_fragments"] else None,
            version=self.optimization_manager.classifier_version,
        )

        fdr_cutoff = self.config["fdr"]["fdr"]
        # the q-value filter only: decoy PSMs at <= fdr stay, as the
        # cross-run protein FDR needs them as its null
        psm = take(psm, psm["qval"] <= fdr_cutoff)

        # the fragments of the surviving candidates
        keep = candidate_hash(psm["precursor_idx"], psm["rank"])
        fragments = take(fragments, np.isin(candidate_hash(fragments["precursor_idx"], fragments["rank"]), keep))

        logger.log(
            25, "Extraction: %d precursors at %.0f%% FDR, %d fragments", n_rows(psm), fdr_cutoff * 100, n_rows(fragments)
        )
        self.reporter.log_metric("extraction.precursors", n_rows(psm))
        self.reporter.log_metric("extraction.fragments", n_rows(fragments))
        self.timing_manager.save()
        return psm, fragments

    @use_timing_manager("requantify")
    def requantify(self, psm_df: dict) -> tuple[dict, dict]:
        """Multiplexing: the confident PSMs carried to every channel of
        their elution group, rescored, with channel q-values."""
        return MultiplexingHandler(
            self.config, self.fdr_manager, self._extraction_handler(), self.calibration_manager
        ).requantify(self.dia_data, self.spectral_library, psm_df)

    @use_timing_manager("requantify_fragments")
    def requantify_fragments(self, psm_df: dict) -> tuple[dict, dict]:
        """The confident PSMs quantified over the whole transfer fragment
        space."""
        return TransferRequantHandler(
            self.config, self.calibration_manager, self.optimization_manager, devices=self.devices
        ).requantify(self.dia_data, psm_df)
