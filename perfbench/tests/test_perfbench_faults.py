"""A run with its timed path broken underneath comes out not correct: half
of each batch left out, an answer altered where it is produced, and the
peaks past a slab cut away. The look for a card is skipped (the CPU)."""

import numpy as np
import pytest

from perfbench.bench.cell import run_cell


def _half(orig):
    def select_and_score(self, dia, lib):
        n = len(lib.precursor_df["precursor_idx"])
        lib.precursor_df = {k: v[: n // 2] for k, v in lib.precursor_df.items()}
        return orig(self, dia, lib)

    return select_and_score


def _shift_apex(orig):
    def select_and_score(self, dia, lib):
        cand, psm, frag = orig(self, dia, lib)
        for frame in (cand, psm):
            frame["frame_center"] = frame["frame_center"] + 1
        return cand, psm, frag

    return select_and_score


def _scale_feature(orig):
    def select_and_score(self, dia, lib):
        cand, psm, frag = orig(self, dia, lib)
        psm["intensity_correlation"] = psm["intensity_correlation"] * np.float32(1.05)
        return cand, psm, frag

    return select_and_score


@pytest.mark.parametrize("cell", ["tiny3d.final", "tiny4d.final"])
@pytest.mark.parametrize("fault", [_half, _shift_apex, _scale_feature])
def test_broken_extraction_is_not_correct(tiny_root, monkeypatch, cell, fault):
    from alphadia_torch.workflow.peptidecentric.extraction_handler import ExtractionHandler

    monkeypatch.setattr(ExtractionHandler, "select_and_score", fault(ExtractionHandler.select_and_score))
    result, lines = run_cell(cell, 8, 0.5, False, 0.0, device="cpu", root=tiny_root)
    assert result["correct"] is False, lines


def test_a_cut_slab_is_not_correct(tiny_root):
    """The program reading at most 4 peaks a query (``tpu.gather_slab``)
    loses peaks that the reference reads."""
    import json

    path = tiny_root / "perfbench" / "traffic" / "final.json"
    t = json.loads(path.read_text())
    t["tpu"]["gather_slab"] = 4
    path.write_text(json.dumps(t))
    result, lines = run_cell("tiny3d.final", 8, 0.5, False, 0.0, device="cpu", root=tiny_root)
    assert result["correct"] is False, lines


@pytest.mark.parametrize("cell", ["tiny3d.final", "tiny4d.final"])
def test_sound_run_is_correct(tiny_root, cell):
    result, lines = run_cell(cell, 8, 0.5, False, 0.0, device="cpu", root=tiny_root)
    assert result["correct"] is True, lines
