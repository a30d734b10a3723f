"""The search plan: up to three search steps, a transfer step, a library
step and a match-between-runs (MBR) step.

``SearchPlan(output_directory, config, cli_config).run_plan()``:

- with ``general.transfer_step_enabled`` a transfer step first, in
  ``transfer/``, with ``TRANSFER_EXTRA``: it writes the transfer library and
  fine-tunes the property models on it (``peptdeep.transfer/``); its
  optimized tolerances (``_get_optimized_values_config``: the median over
  runs of ``stat.tsv``'s ``optimization.*``) and, where ``models.pkl`` was
  written, ``library_prediction.peptdeep_model_path`` are the extras of the
  steps after it;
- with ``general.mbr_step_enabled`` the library step in ``library/`` with
  ``save_mbr_library``, whose outputs write ``speclib.mbr.hdf`` (the
  precursors it identified); the MBR step then searches every run again in
  the output directory with that flat library, from the transfer extras,
  the library step's optimized tolerances and ``MBR_EXTRA``;
- else one step in the output directory, with the transfer extras.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from alphadia_torch.constants.keys import StatOutputCols
from alphadia_torch.models.finetune import MODEL_DIR_NAME
from alphadia_torch.reporting import PROGRESS
from alphadia_torch.search_step import SearchStep
from alphadia_torch.utils.tsv import read_tsv

logger = logging.getLogger(__name__)

TRANSFER_STEP_NAME = "transfer"
LIBRARY_STEP_NAME = "library"
MBR_STEP_NAME = "mbr"

# the steps' config overrides (the reference's constants/multistep.yaml)
TRANSFER_EXTRA = {
    "transfer_library": {"enabled": True},
    "transfer_learning": {"enabled": True},
}
MBR_EXTRA = {
    "search": {"target_num_candidates": 5},
    "fdr": {"inference_strategy": "library"},
}


def _merge(*layers: dict) -> dict:
    """Deep-merge dict layers left to right (later layers win)."""
    out: dict = {}
    for layer in layers:
        for k, v in layer.items():
            if isinstance(v, dict) and isinstance(out.get(k), dict):
                out[k] = _merge(out[k], v)
            else:
                out[k] = v
    return out


class SearchPlan:
    def __init__(self, output_directory: str, config: dict | None = None, cli_config: dict | None = None, device=None):
        self.output_directory = Path(output_directory)
        self.user_config = config or {}
        self.cli_config = cli_config or {}
        self.device = device
        general = {**(config or {}).get("general", {}), **(cli_config or {}).get("general", {})}
        self.transfer_step_enabled = bool(general.get("transfer_step_enabled", False))
        self.mbr_step_enabled = bool(general.get("mbr_step_enabled", False))

    def run_plan(self) -> None:
        extra: dict = {}
        if self.transfer_step_enabled:
            logger.log(PROGRESS, "=== multistep: transfer step ===")
            transfer_dir = self.output_directory / TRANSFER_STEP_NAME
            self.run_step(transfer_dir, {k: dict(v) for k, v in TRANSFER_EXTRA.items()})
            extra = _merge(extra, self._get_optimized_values_config(transfer_dir))
            model_path = transfer_dir / MODEL_DIR_NAME
            if (model_path / "models.pkl").exists():
                extra = _merge(extra, {"library_prediction": {"peptdeep_model_path": str(model_path)}})
        if not self.mbr_step_enabled:
            self.run_step(self.output_directory, extra)
            return
        logger.log(PROGRESS, "=== multistep: library step ===")
        library_dir = self.output_directory / LIBRARY_STEP_NAME
        self.run_step(library_dir, _merge(extra, {"general": {"save_mbr_library": True}}))
        mbr_lib = library_dir / "speclib.mbr.hdf"
        logger.log(PROGRESS, "=== multistep: mbr step ===")
        # the transfer extras and the library step's optimized tolerances:
        # without them the MBR step would optimize again from the wide initial
        # ones and, without its library, predict with the packaged models
        mbr_extra = _merge(extra, self._get_optimized_values_config(library_dir), MBR_EXTRA)
        if mbr_lib.exists():
            mbr_extra = _merge(mbr_extra, {"library_path": str(mbr_lib), "general": {"input_library_type": "flat"}})
        self.run_step(self.output_directory, mbr_extra)

    def run_step(self, output_dir: Path, extra_config: dict) -> None:
        SearchStep(
            str(output_dir), config=self.user_config, cli_config=self.cli_config, extra_config=extra_config,
            device=self.device,
        ).run()

    @staticmethod
    def _get_optimized_values_config(step_dir: Path) -> dict:
        """Median optimized tolerances over runs from the step's stat.tsv."""
        stat_path = Path(step_dir) / "stat.tsv"
        if not stat_path.exists():
            return {}
        stat = read_tsv(stat_path)
        out: dict = {"search": {}}
        prefix = StatOutputCols.OPTIMIZATION_PREFIX
        for key, target in (("ms1_error", "target_ms1_tolerance"), ("ms2_error", "target_ms2_tolerance")):
            col = stat.get(f"{prefix}{key}")
            if col is not None and col.dtype.kind in "iuf" and np.isfinite(col.astype(np.float64)).any():
                out["search"][target] = float(np.nanmedian(col.astype(np.float64)))
        return out if out["search"] else {}
