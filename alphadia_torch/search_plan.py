"""The search plan: one search step, or (not ported yet) a transfer step
before it and an MBR step after it.

``SearchPlan(output_directory, config, cli_config).run_plan()`` runs a
``SearchStep`` in the output directory. The multistep plan's transfer step
(``general.transfer_step_enabled``) needs the transfer library and model
(ROADMAP queue 1 items 5 and 6) and its MBR step
(``general.mbr_step_enabled``) reads the MBR library back from HDF (items 4
and 5): both raise ``NotPortedError`` before any work.
``_get_optimized_values_config`` gives the tolerances a later step starts
from (the median over runs of ``stat.tsv``'s ``optimization.*``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from alphadia_torch.constants.keys import StatOutputCols
from alphadia_torch.exceptions import NotPortedError
from alphadia_torch.search_step import SearchStep
from alphadia_torch.utils.tsv import read_tsv

TRANSFER_STEP_NAME = "transfer"
LIBRARY_STEP_NAME = "library"
MBR_STEP_NAME = "mbr"


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
                "general.transfer_step_enabled: the transfer step needs the transfer library and model, which come "
                "with the requant and prediction slices of the port (ROADMAP queue 1 items 5 and 6)"
            )
        if self.mbr_step_enabled:
            raise NotPortedError(
                "general.mbr_step_enabled: the MBR step reads the MBR library from HDF, which comes with the HDF "
                "slice of the port (ROADMAP queue 1 items 4 and 5)"
            )
        self.run_step(self.output_directory, {})

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
