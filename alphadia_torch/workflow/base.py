"""Workflow base: the run's folder, reporter, raw data and managers.

``quant/<raw name>/`` under the output directory (or ``quant_path``) holds
the run's ``events.jsonl``, the managers' pickles and, with
``general.save_figures``, ``figures/``.
"""

from __future__ import annotations

from pathlib import Path

from alphadia_torch.reporting.reporting import default_pipeline
from alphadia_torch.utils.device import resolve_device
from alphadia_torch.workflow.managers.calibration_manager import CalibrationManager
from alphadia_torch.workflow.managers.optimization_manager import OptimizationManager
from alphadia_torch.workflow.managers.raw_file_manager import RawFileManager
from alphadia_torch.workflow.managers.timing_manager import TimingManager

QUANT_FOLDER_NAME = "quant"


class WorkflowBase:
    CALIBRATION_MANAGER_PKL = "calibration_manager.pkl"
    OPTIMIZATION_MANAGER_PKL = "optimization_manager.pkl"
    TIMING_MANAGER_PKL = "timing_manager.pkl"

    def __init__(self, instance_name: str, config, quant_path: str | None = None, device=None, devices=None):
        self.instance_name = instance_name
        self.config = config
        # the card unless the CPU is asked for; raises without a card.
        # ``devices``: the devices that the drivers split their batches
        # across; the rest of the run (FDR fits, calibration) is on the first
        self.devices = [resolve_device(d) for d in devices] if devices else [resolve_device(device)]
        self.device = self.devices[0]
        base = Path(quant_path or Path(config["output_directory"]) / QUANT_FOLDER_NAME)
        self.path = base / instance_name
        self.path.mkdir(parents=True, exist_ok=True)
        self.reporter = default_pipeline(self.path, save_figures=config["general"]["save_figures"])
        self.dia_data = None
        self.spectral_library = None
        self.calibration_manager = None
        self.optimization_manager = None
        self.timing_manager = TimingManager(
            self.path / self.TIMING_MANAGER_PKL, load_from_file=config["general"]["reuse_calibration"]
        )

    def load(self, raw_path: str, spectral_library) -> None:
        reuse = self.config["general"]["reuse_calibration"]
        self.dia_data = RawFileManager(self.config).get_dia_data_object(raw_path)

        self.calibration_manager = CalibrationManager(
            self.path / self.CALIBRATION_MANAGER_PKL,
            load_from_file=reuse,
            has_ms1=self.dia_data.has_ms1,
            has_mobility=self.dia_data.has_mobility,
        )
        self.optimization_manager = OptimizationManager(
            self.config,
            gradient_length=self.dia_data.rt_max - self.dia_data.rt_min,
            path=self.path / self.OPTIMIZATION_MANAGER_PKL,
            load_from_file=reuse,
        )
