"""The final extraction: the whole library through
``ExtractionHandler.select_and_score`` at the calibrated tolerances.

The window sends the library in order, ``slice_precursors`` rows a call,
each call a library of its own (those rows and their fragments, as the
calibration's batches are); each call shifts the library RTs of its rows by a uniform jitter of
``rt_jitter_s`` drawn from the seed, so that no pass repeats the last one's
work. A call's rows, RTs and outputs are its record.
"""

from __future__ import annotations

import numpy as np

from perfbench.bench import program

END_TO_END = "precursors_per_s"


class Loop:
    unit = "call"
    unit_span = "select_and_score"  # the span of one unit

    def __init__(self, run):
        t = run.traffic
        self.run = run
        self.cfg = program.config({**t["tpu"], **run.config["program"].get("tpu", {})})
        self.mgr = program.optimization_state(self.cfg, run.dia, {
            "ms1_error": t["ms1_tolerance_ppm"], "ms2_error": t["ms2_tolerance_ppm"],
            "rt_error": t["rt_tolerance_s"], "num_candidates": t["num_candidates"],
        })
        self.handler = program.extraction_handler(self.cfg, self.mgr, run.dia, run.device)
        self.n = len(run.world.precursor["precursor_idx"])
        self.size = min(int(t["slice_precursors"]), self.n)
        self.jitter = float(t["rt_jitter_s"])
        self.rng = np.random.default_rng([int(run.seed), 3])
        self.at = 0
        self.warmup_units = int(t["warmup_calls"])
        self.trace_units = int(t["trace_calls"])

    def step(self, spans) -> dict:
        a = self.at
        b = min(a + self.size, self.n)
        self.at = b % self.n
        prec, frag_rows = program.rows_of(self.run.world.precursor, slice(a, b))
        rt = (prec["rt_library"] + self.rng.uniform(-self.jitter, self.jitter, b - a)).astype(np.float32)
        prec["rt_library"] = rt
        lib = program.library(prec, program.rows_of(self.run.world.fragment, frag_rows)[0])
        with spans.span("select_and_score"):
            cand, psm, frag = self.handler.select_and_score(self.run.dia, lib)
        return {"rows": np.arange(a, b), "rt": rt, "cand": cand, "psm": psm, "frag": frag, "work": b - a}

    def om(self) -> dict:
        return program.om_values(self.mgr)

    def end_to_end(self, window) -> dict:
        return {END_TO_END: window.work / window.seconds}
