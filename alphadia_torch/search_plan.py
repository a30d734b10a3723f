"""The search plan: one search step, or a library step and a
match-between-runs (MBR) step after it.

``SearchPlan(output_directory, config, cli_config).run_plan()`` runs a
``SearchStep`` in the output directory. With ``general.mbr_step_enabled`` it
first runs the library step in ``library/`` with ``save_mbr_library``, whose
outputs write ``speclib.mbr.hdf`` (the precursors it identified); the MBR
step then searches every run again in the output directory with that flat
library, from the library step's optimized tolerances
(``_get_optimized_values_config``: the median over runs of ``stat.tsv``'s
``optimization.*``) and ``MBR_EXTRA``. The transfer step
(``general.transfer_step_enabled``) needs the fine-tuned models (ROADMAP
queue 1 item 6): it raises ``NotPortedError`` before any step runs.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from alphadia_torch.constants.keys import StatOutputCols
from alphadia_torch.exceptions import NotPortedError
from alphadia_torch.reporting import PROGRESS
from alphadia_torch.search_step import SearchStep
from alphadia_torch.utils.tsv import read_tsv

logger = logging.getLogger(__name__)

TRANSFER_STEP_NAME = "transfer"
LIBRARY_STEP_NAME = "library"
MBR_STEP_NAME = "mbr"

# the MBR step's config overrides (the reference's constants/multistep.yaml)
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
        if self.transfer_step_enabled:
            raise NotPortedError(
                "general.transfer_step_enabled: the transfer step fine-tunes the property models on the transfer "
                "library, which comes with the transfer-learning slice of the port (ROADMAP queue 1 item 6)"
            )
        if not self.mbr_step_enabled:
            self.run_step(self.output_directory, {})
            return
        logger.log(PROGRESS, "=== multistep: library step ===")
        library_dir = self.output_directory / LIBRARY_STEP_NAME
        self.run_step(library_dir, {"general": {"save_mbr_library": True}})
        mbr_lib = library_dir / "speclib.mbr.hdf"
        logger.log(PROGRESS, "=== multistep: mbr step ===")
        # the library step's optimized tolerances: without them the MBR step
        # would optimize again from the wide initial ones
        mbr_extra = _merge(self._get_optimized_values_config(library_dir), MBR_EXTRA)
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
