"""Selection and scoring as one pipeline on the card.

``CandidateSelection`` then ``CandidateScoring`` run one after the other:
scoring starts once every selection batch has come back and decoded. This
driver overlaps them:

- every selection batch is enqueued first, each with its asynchronous copy
  to pinned host memory (the card's stream runs them in order, so the card
  is busy with selection while the host does the rest);
- the scoring library arrays are uploaded while selection computes: they
  do not depend on the candidates;
- each selection batch is decoded as soon as its own copy has landed, its
  candidates join a buffer, and every full scoring chunk is enqueued at
  once, so scoring chunk k runs while later selection batches decode;
- the tail goes out in the power-of-two schedule of ``batch_schedule``,
  and the scoring outputs are read back in dispatch order at the end.

The result equals the sequential drivers': batches are independent, and
each chunk's window bucket W only pads the candidates' extents (scoring
reads every XIC from the candidate's first cycle, so the peaks that a full
slab keeps do not depend on W either: ``ops/scoring``).

With several devices (either driver's ``_mesh()``) the two drivers run
one after the other, each splitting its batches across the devices, as the
JAX driver falls back under a device mesh. Either way the spans under a
profiler are the two drivers' own (``utils/profiling``), and the geometry's
concatenations here are ``scoring.geometry`` spans.
"""

from __future__ import annotations

import logging
import time
from dataclasses import replace

import numpy as np

from alphadia_torch.rawdata.diadata import DiaData
from alphadia_torch.search.scoring import (
    GEO_KEYS,
    CandidateScoring,
    ScoringConfig,
    empty_fragments,
    empty_psms,
    window_bucket,
)
from alphadia_torch.search.selection import (
    CANDIDATE_COLUMNS,
    CandidateSelection,
    SelectionConfig,
    empty_candidates,
)
from alphadia_torch.utils.device import batch_schedule
from alphadia_torch.utils.profiling import span

logger = logging.getLogger(__name__)


def _geo_concat(parts: list[dict]) -> dict:
    with span("scoring.geometry"):
        return {k: np.concatenate([p[k] for p in parts]) for k in GEO_KEYS}


class PipelinedExtraction:
    """Selection and scoring overlapped; returns ``(candidates, psm,
    fragments)`` column dicts equal to the sequential drivers' output."""

    def __init__(
        self,
        dia_data: DiaData,
        precursor: dict,
        fragment: dict,
        sel_config: SelectionConfig | None = None,
        score_config: ScoringConfig | None = None,
        rt_column: str = "rt_library",
        precursor_mz_column: str = "mz_library",
        fragment_mz_column: str = "mz_library",
        sel_batch_cap: int = 4096,
        device=None,
        devices=None,
    ):
        sel_config = sel_config or SelectionConfig()
        # smaller selection batches bring the first candidates (and the
        # first scoring chunk) sooner
        if sel_config.batch_size > sel_batch_cap:
            sel_config = replace(sel_config, batch_size=sel_batch_cap)
        kw = dict(
            rt_column=rt_column,
            precursor_mz_column=precursor_mz_column,
            fragment_mz_column=fragment_mz_column,
            device=device,
            devices=devices,
        )
        self.selection = CandidateSelection(dia_data, precursor, fragment, sel_config, **kw)
        self.scoring = CandidateScoring(dia_data, precursor, fragment, score_config, **kw)

    def __call__(self) -> tuple[dict, dict, dict]:
        sel = self.selection
        score = self.scoring
        if sel._mesh() is not None or score._mesh() is not None:
            cand = sel()
            psm, fragments = score(cand)
            return cand, psm, fragments

        t_start = time.perf_counter()
        state = sel._submit()
        if state is None:  # empty library
            return empty_candidates(), empty_psms(), empty_fragments()

        # the library upload runs while the card computes selection
        lib, lib_dev = score._upload_lib()
        dev = score.dia.device_arrays(1, score.device)
        cap = score._batch_cap()

        cand_frames: list[dict] = []
        all_parts: list[dict] = []  # every frame's geometry, in order
        buf_parts: list[dict] = []  # geometry not yet dispatched
        buffered = 0
        pending = []
        def dispatch(geo: dict, a: int, b: int):
            pending.append(score._dispatch([score.device], [dev], [lib_dev], geo, a, b, window_bucket(geo, a, b)))

        for _, frame in sel._harvest_iter(state):
            if not len(frame["precursor_idx"]):
                continue
            cand_frames.append(frame)
            part = score._candidate_geometry(frame)
            part = {k: part[k] for k in GEO_KEYS}
            all_parts.append(part)
            buf_parts.append(part)
            buffered += len(frame["precursor_idx"])
            if buffered < cap:
                continue
            # enqueue every full scoring chunk at once
            geo_buf = _geo_concat(buf_parts)
            off = 0
            while buffered - off >= cap:
                dispatch(geo_buf, off, off + cap)
                off += cap
            buf_parts = [{k: v[off:] for k, v in geo_buf.items()}] if buffered > off else []
            buffered -= off

        # the tail: the power-of-two schedule bounds the padded rows
        if buffered:
            geo_buf = _geo_concat(buf_parts)
            for b0, bsz in batch_schedule(buffered, cap):
                dispatch(geo_buf, b0, min(b0 + bsz, buffered))

        if not cand_frames:
            return empty_candidates(), empty_psms(), empty_fragments()

        cand = {k: np.concatenate([f[k] for f in cand_frames]) for k in CANDIDATE_COLUMNS}
        psm, fragments = score._harvest(pending, cand, lib, _geo_concat(all_parts))
        logger.info(
            "Pipelined extraction: %d candidates -> %d PSMs in %.2f s",
            len(cand["precursor_idx"]), len(psm["precursor_idx"]), time.perf_counter() - t_start,
        )
        return cand, psm, fragments
