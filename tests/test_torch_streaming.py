"""The port's RT-windowed search against the JAX package's and against the
port's whole-run search (the cases of ``tests/unit/test_streaming.py``),
on the CPU.

- ``iter_rt_windows`` gives JAX's windows exactly: the core range, the
  spectra of each window (their RT) and its first cycle;
- ``RtWindowedSearch`` with 4 windows against the whole-run
  ``PipelinedExtraction``: the same PSM keys, each precursor searched
  once, absolute ``frame_center`` equal, features within rtol 1e-5 /
  atol 1e-5 (JAX's tolerance for the same comparison), as many fragments;
  in 3D, and in 4D, where each window must keep the whole run's scan bins
  (binned by a window's own mobility range, as the JAX driver bins them,
  the 4D candidates move); and where the bucketed selection window reaches
  past the JAX driver's pad (``rt_tolerance`` + 30 s): padded so, 2 of 308
  PSMs move.
"""

import numpy as np
import pytest

from alphadia_torch.search.pipelined import PipelinedExtraction
from alphadia_torch.search.scoring import FEATURE_COLUMNS, ScoringConfig
from alphadia_torch.search.selection import SelectionConfig
from alphadia_torch.search.streaming import RtWindowedSearch, iter_rt_windows
from alphadia_torch.rawdata import DiaData
from alphadia_torch.rawdata.source import SpectrumData
from alphadia_torch.convert import frame_from_pandas
from alphadia_tpu.search.streaming import iter_rt_windows as jax_iter_rt_windows
from alphadia_tpu.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
from torch_compare import sorted_rows

pytest_plugins = ("torch_port_plugin",)


def _port_spectra(s) -> SpectrumData:
    return SpectrumData(**{k: getattr(s, k) for k in SpectrumData.__dataclass_fields__})


@pytest.mark.parametrize("n_windows,pad_s", [(5, 20.0), (4, 70.0), (1, 30.0)])
def test_iter_rt_windows_matches_jax(n_windows, pad_s):
    spectra, _, _ = make_synthetic_dia(SyntheticConfig(n_peptides=40, n_windows=4, n_cycles=200, seed=1))
    theirs = list(jax_iter_rt_windows(spectra, n_windows, pad_s))
    ours = list(iter_rt_windows(_port_spectra(spectra), n_windows, pad_s))
    assert len(ours) == len(theirs) == n_windows
    for (core, sub, c0), (core_j, sub_j, c0_j) in zip(ours, theirs):
        assert core == core_j and c0 == c0_j
        assert sub.ms_level[0] == 1
        np.testing.assert_array_equal(sub.rt, sub_j.rt)
        np.testing.assert_array_equal(sub.mz, sub_j.mz)


WORLDS = {
    # name: (world, RT windows, rt_tolerance)
    "3d": (dict(n_peptides=250, n_windows=6, n_cycles=400, seed=23), 4, 40.0),
    "4d": (dict(n_peptides=120, n_windows=4, n_cycles=300, seed=7, with_mobility=True), 3, 40.0),
    # 100 s at a 1.5 s cycle is 67 cycles, a selection window of 128: 96 s
    # a side, past the JAX driver's pad of rt_tolerance + 30 s
    "3d_bucketed_window": (dict(n_peptides=300, n_windows=4, n_cycles=600, seed=23), 4, 50.0),
}


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_windowed_matches_whole_run(world):
    kw, n_rt_windows, rt_tolerance = WORLDS[world]
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(**kw))
    prec, frag = add_synthetic_decoys(prec, frag)
    spectra, prec, frag = _port_spectra(spectra), frame_from_pandas(prec), frame_from_pandas(frag)
    sel_cfg = SelectionConfig(rt_tolerance=rt_tolerance, candidate_count=2, batch_size=512)
    score_cfg = ScoringConfig(batch_size=512, collect_fragments=True)

    dia = DiaData.from_spectra(spectra)
    _, psm_whole, frag_whole = PipelinedExtraction(dia, prec, frag, sel_cfg, score_cfg, device="cpu")()
    sw = RtWindowedSearch(spectra, prec, frag, sel_cfg, score_cfg, n_rt_windows=n_rt_windows, device="cpu")
    psm_win, frag_win = sw()

    assert sw.peak_window_slab_mb > 0
    keys = set(zip(psm_win["precursor_idx"].tolist(), psm_win["rank"].tolist()))
    assert len(keys) == len(psm_win["precursor_idx"])  # every precursor searched once
    assert len(psm_win["precursor_idx"]) == len(psm_whole["precursor_idx"]) > 100
    assert sw.pad_s >= rt_tolerance + 30.0
    a, b = sorted_rows(psm_whole), sorted_rows(psm_win)
    np.testing.assert_array_equal(a["precursor_idx"], b["precursor_idx"])
    np.testing.assert_array_equal(a["rank"], b["rank"])
    np.testing.assert_array_equal(a["frame_center"], b["frame_center"])
    np.testing.assert_allclose(
        np.stack([b[f] for f in FEATURE_COLUMNS], 1), np.stack([a[f] for f in FEATURE_COLUMNS], 1),
        rtol=1e-5, atol=1e-5,
    )
    assert len(frag_win["mz"]) == len(frag_whole["mz"])
