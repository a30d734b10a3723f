"""The generator: the same seed gives the same run, and the planted truth
agrees with the spectra."""

import numpy as np

import tiny
from perfbench.gen.world import make_world


def _arrays(w):
    out = {k: getattr(w, k) for k in ("rt", "spec_start", "mz", "intensity")}
    out.update({f"p.{k}": v for k, v in w.precursor.items()})
    out.update({f"f.{k}": v for k, v in w.fragment.items()})
    out.update({f"t.{k}": v for k, v in w.truth.items()})
    return out


def test_same_seed_same_run_other_seed_other_run():
    a, b = (_arrays(make_world(tiny.WORLD_3D, 2**31 + 11, "cpu")) for _ in range(2))
    c = _arrays(make_world(tiny.WORLD_3D, 5, "cpu"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.array_equal(a["mz"], c["mz"]) or len(a["mz"]) != len(c["mz"])


def test_sizes_do_not_depend_on_the_seed():
    for seed in (1, 2**32 + 7):
        w = make_world(tiny.WORLD_3D, seed, "cpu")
        n_t = tiny.WORLD_3D["n_targets"]
        assert len(w.precursor["precursor_idx"]) == 2 * n_t
        assert int(w.truth["detectable"].sum()) == tiny.WORLD_3D["n_detectable"]
        assert len(w.fragment["mz_library"]) == 2 * n_t * tiny.WORLD_3D["n_fragments"]
        assert w.n_spectra == tiny.WORLD_3D["n_cycles"] * (tiny.WORLD_3D["n_windows"] + 1)


def test_spectra_sorted_and_planted_truth_in_them():
    cfg = tiny.WORLD_4D
    w = make_world(cfg, 77, "cpu")
    counts = np.diff(w.spec_start)
    assert counts.sum() == len(w.mz) == len(w.mobility)
    for s in range(0, w.n_spectra, 97):  # m/z ascending within each spectrum
        assert np.all(np.diff(w.mz[w.spec_start[s]:w.spec_start[s + 1]]) >= 0)
    # at each detectable target's apex, its window's spectrum holds each of
    # its fragments within 20 ppm of the library m/z (before the library's bias)
    det = np.flatnonzero(w.truth["detectable"])
    bias = 1 + cfg["lib_ppm_bias"] * 1e-6
    found = 0
    for r in det[:40]:
        mz = w.precursor["mz_library"][r] * bias
        win = np.searchsorted(w.window_edges, mz, side="right") - 1
        spec = w.truth["apex_cycle"][r] * w.n_slots + 1 + win
        peaks = w.mz[w.spec_start[spec]:w.spec_start[spec + 1]].astype(np.float64)
        a, b = w.precursor["flat_frag_start_idx"][r], w.precursor["flat_frag_stop_idx"][r]
        frags = w.fragment["mz_library"][a:b].astype(np.float64) * bias
        near = np.abs(peaks[None, :] - frags[:, None]) <= 20e-6 * frags[:, None]
        found += near.any(1).mean() >= 0.8
        assert abs(w.truth["mobility"][r] - w.precursor["mobility_library"][r]) < 0.1
    assert found >= 36
    # decoys share their target's elution group and plant nothing
    assert not w.truth["detectable"][1::2].any()
    np.testing.assert_array_equal(w.precursor["elution_group_idx"][0::2], w.precursor["elution_group_idx"][1::2])
