"""Extraction handler: the optimization state handed to the drivers.

``select_candidates`` then ``score_and_quantify_candidates`` for the final
extraction, with the score cutoff applied after selection; ``select_and_score``
(the pipelined driver, no cutoff) for the optimization steps. The drivers
read the calibrated columns by name (``ColumnNameHandler``).

The JAX package's selection and scoring never receive the mobility
tolerance (``mobility_error``), and neither do the port's: on 4D data the
mobility optimizer steps a parameter that no driver reads (ROADMAP §3).
The JAX package's light transport of the optimization steps (no per-fragment
quant in the download) has no counterpart: the port's drivers copy what
they compute, and the loop reads none of the quant columns.
"""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.rawdata import DiaData
from alphadia_torch.search.pipelined import PipelinedExtraction
from alphadia_torch.search.scoring import CandidateScoring, ScoringConfig
from alphadia_torch.search.selection import CandidateSelection, SelectionConfig
from alphadia_torch.utils.device import resolve_device
from alphadia_torch.utils.frame import n_rows, take

logger = logging.getLogger(__name__)


def _resolve_compute_dtype(setting: str, device) -> str:
    """'auto' -> bfloat16 on the card, float32 on the CPU (m/z math is
    float32 either way)."""
    if setting != "auto":
        return setting
    return "float32" if resolve_device(device).type == "cpu" else "bfloat16"


class ExtractionHandler:
    def __init__(self, config, optimization_manager, column_name_handler, device=None, devices=None):
        self._config = config
        self._om = optimization_manager
        self._cols = column_name_handler
        # the drivers split their batches across ``devices`` (at most
        # tpu.mesh_devices of them); default the one device
        self.devices = [resolve_device(d) for d in devices] if devices else [resolve_device(device)]
        self.device = self.devices[0]

    @classmethod
    def create_handler(cls, config, optimization_manager, column_name_handler, device=None, devices=None):
        return cls(config, optimization_manager, column_name_handler, device=device, devices=devices)

    def _selection_config(self) -> SelectionConfig:
        cfg = self._config
        return SelectionConfig(
            rt_tolerance=self._om.rt_error,
            precursor_mz_tolerance=self._om.ms1_error,
            fragment_mz_tolerance=self._om.ms2_error,
            candidate_count=int(self._om.num_candidates),
            top_k_fragments=cfg["search"]["top_k_fragments_selection"],
            exclude_shared_ions=cfg["search"]["exclude_shared_ions"],
            fwhm_rt=self._om.fwhm_rt,
            batch_size=cfg["tpu"]["selection_batch"],
            gather_slab=cfg["tpu"]["gather_slab"],
            coarsen_wide_windows=cfg["tpu"]["coarsen_wide_windows"],
            mesh_devices=cfg["tpu"]["mesh_devices"],
        )

    def _scoring_config(self) -> ScoringConfig:
        cfg = self._config
        return ScoringConfig(
            precursor_mz_tolerance=self._om.ms1_error,
            fragment_mz_tolerance=self._om.ms2_error,
            top_k_fragments=cfg["search"]["top_k_fragments_scoring"],
            exclude_shared_ions=cfg["search"]["exclude_shared_ions"],
            quant_window=cfg["search"]["quant_window"],
            quant_all=cfg["search"]["quant_all"],
            experimental_xic=cfg["search"]["experimental_xic"],
            batch_size=cfg["tpu"]["scoring_batch"],
            gather_slab=cfg["tpu"]["gather_slab"],
            quad_sigma=tuple(self._om.quad_sigma),
            quad_delta_mu=tuple(self._om.quad_delta_mu),
            compute_dtype=_resolve_compute_dtype(cfg["tpu"]["compute_dtype"], self.device),
            mesh_devices=cfg["tpu"]["mesh_devices"],
        )

    def _columns(self) -> dict:
        return dict(
            rt_column=self._cols.get_rt_column(),
            precursor_mz_column=self._cols.get_precursor_mz_column(),
            fragment_mz_column=self._cols.get_fragment_mz_column(),
            devices=self.devices,
        )

    def select_candidates(self, dia_data: DiaData, lib, apply_cutoff: bool = False) -> dict:
        selection = CandidateSelection(
            dia_data, lib.precursor_df, lib.fragment_df, self._selection_config(), **self._columns()
        )
        candidates = selection()

        # the cutoff only saves scoring work on large libraries; on small
        # candidate pools it starves the FDR of decoys
        n_before = n_rows(candidates)
        if apply_cutoff and self._om.score_cutoff > 0 and n_before > 5000:
            keep = np.nonzero(candidates["score"] > self._om.score_cutoff)[0]
            # selection scores are standardised over the RT window, so a
            # cutoff learned at a wider window can overshoot at the final
            # tolerance: it never empties the candidate list
            if len(keep) == 0:
                logger.warning(
                    "score cutoff %.3f would drop all %d candidates; skipping cutoff", self._om.score_cutoff, n_before
                )
            else:
                candidates = take(candidates, keep)
                logger.info(
                    "Applied score cutoff %.3f: %d/%d candidates retained", self._om.score_cutoff, len(keep), n_before
                )
        return candidates

    def select_and_score(self, dia_data: DiaData, lib) -> tuple[dict, dict, dict]:
        """Pipelined selection and scoring, no score cutoff (the shape of
        the optimization steps): (candidates, PSMs, fragments), equal to
        ``select_candidates`` + ``score_and_quantify_candidates``."""
        pipe = PipelinedExtraction(
            dia_data, lib.precursor_df, lib.fragment_df, self._selection_config(), self._scoring_config(),
            **self._columns(),
        )
        return pipe()

    def score_and_quantify_candidates(self, candidates: dict, dia_data: DiaData, lib) -> tuple[dict, dict]:
        scoring = CandidateScoring(
            dia_data, lib.precursor_df, lib.fragment_df, self._scoring_config(), **self._columns()
        )
        return scoring(candidates)
