"""The port's kernel debug plots (``alphadia_torch/search/plotting.py``)
against the JAX package's, read through matplotlib's artists:

- each of the four plotters on the same inputs: every line's data,
  colour, style, width, alpha and label; every rectangle (bars, spans);
  ``axvline`` positions; texts; titles, axis labels, legend labels and the
  limits; the figure's size and its pixel size at the figure backend's
  150 dpi;
- ``debug_candidates`` on the small world of JAX's
  ``tests/unit/test_plotting.py`` (40 peptides, 4 windows, 120 cycles,
  seed 3): the dense arrays of each candidate, the figure names and the
  files written, at JAX's pixel sizes. JAX extracts through its XLA path,
  whose float32 prefix sums leave an absolute error that scales with the
  intensity summed over a slab, not with the element (ROADMAP §3). The
  fragment traces hold at rtol 1e-5, atol 1e-3. The isotope traces sum
  MS1 peaks some ten times as intense, and the template is built from
  them: they hold at rtol 1e-5 and an atol of 1e-6 of the candidate's
  highest value (measured: at most 3.2e-7 of it; 1e-3 alone leaves 1-2
  elements of 48 outside on three of the eight candidates).
"""

import matplotlib
import numpy as np
import pytest

import alphadia_torch.search.plotting as port_plotting
import alphadia_tpu.search.plotting as jax_plotting
from alphadia_torch.convert import config_from_jax, diadata_from_jax, frame_from_pandas
from alphadia_torch.reporting.figure import to_rgb
from alphadia_torch.search.scoring import CandidateScoring as PortScoring
from alphadia_torch.utils.png import read_png
from alphadia_tpu.rawdata import DiaData
from alphadia_tpu.search.scoring import CandidateScoring, ScoringConfig
from alphadia_tpu.search.selection import CandidateSelection, SelectionConfig
from alphadia_tpu.testing.synthetic import SyntheticConfig, make_synthetic_dia

matplotlib.use("Agg")
import matplotlib.colors as mcolors  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

pytest_plugins = ("torch_port_plugin",)

RTOL, ATOL = 1e-5, 1e-3
PEAK_ATOL = 1e-6  # isotopes and template: atol as a share of the candidate's highest value


def assert_close_to_peak(actual, desired):
    np.testing.assert_allclose(actual, desired, rtol=RTOL, atol=max(ATOL, PEAK_ATOL * float(np.abs(desired).max())))


@pytest.fixture(scope="module")
def small_run():
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(n_peptides=40, n_windows=4, n_cycles=120, seed=3))
    return DiaData.from_spectra(spectra), prec, frag


def _hex(c):
    return mcolors.to_hex(c)


def mpl_axes(ax) -> dict:
    legend = ax.get_legend()
    return {
        "lines": [
            {"xy": line.get_xydata(), "color": _hex(line.get_color()), "ls": line.get_linestyle(),
             "lw": line.get_linewidth(), "alpha": 1.0 if line.get_alpha() is None else line.get_alpha(),
             "label": None if line.get_label().startswith("_") else line.get_label()}
            for line in ax.lines
        ],
        "rects": [
            {"xy": tuple(p.get_xy()), "width": p.get_width(), "height": p.get_height(),
             "color": _hex(p.get_facecolor()), "alpha": p.get_alpha()}
            for p in ax.patches
        ],
        "texts": [(tuple(t.get_position()), t.get_text(), t.get_va()) for t in ax.texts],
        "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
        "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
        "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
    }


def port_axes(ax) -> dict:
    prims = ax.primitives
    return {
        "lines": [
            {"xy": np.column_stack([p["x"], p["y"]]), "color": _hex(to_rgb(p["color"])), "ls": p["ls"], "lw": p["lw"],
             "alpha": p["alpha"], "label": p["label"]}
            for p in prims if p["kind"] == "line"
        ],
        "rects": [
            {"xy": (p["x"], p["y"]), "width": p["width"], "height": p["height"], "color": _hex(to_rgb(p["color"])),
             "alpha": p["alpha"]}
            for p in prims if p["kind"] == "rect"
        ],
        "texts": [((p["x"], p["y"]), p["s"], p["va"]) for p in prims if p["kind"] == "text"],
        "title": ax.title, "xlabel": ax.xlabel, "ylabel": ax.ylabel,
        "legend": None if ax.legend_fontsize is None else [lab for lab, _ in ax.legend_entries()],
        "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
    }


def assert_same_figure(mpl_fig, port_fig, tmp_path):
    mpl = [mpl_axes(a) for a in mpl_fig.axes]
    port = [port_axes(a) for a in port_fig.axes]
    assert len(mpl) == len(port)
    for m, p in zip(mpl, port):
        assert len(m["lines"]) == len(p["lines"])
        for a, b in zip(m["lines"], p["lines"]):
            np.testing.assert_array_equal(b["xy"], a["xy"])
            assert (b["color"], b["ls"], b["label"]) == (a["color"], a["ls"], a["label"])
            assert b["lw"] == pytest.approx(a["lw"]) and b["alpha"] == pytest.approx(a["alpha"])
        assert len(m["rects"]) == len(p["rects"])
        for a, b in zip(m["rects"], p["rects"]):
            np.testing.assert_allclose(b["xy"], a["xy"], rtol=1e-12)
            assert b["width"] == pytest.approx(a["width"]) and b["height"] == pytest.approx(a["height"])
            assert (b["color"], b["alpha"]) == (a["color"], a["alpha"])
        assert p["texts"] == m["texts"]
        for k in ("title", "xlabel", "ylabel", "legend"):
            assert p[k] == m[k], k
        np.testing.assert_allclose(p["xlim"], m["xlim"], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(p["ylim"], m["ylim"], rtol=1e-9, atol=1e-12)
    suptitle = mpl_fig._suptitle.get_text() if mpl_fig._suptitle is not None else ""
    assert port_fig.suptitle_text == suptitle
    assert port_fig.figsize == tuple(mpl_fig.get_size_inches())
    mpl_fig.savefig(tmp_path / "mpl.png", dpi=150)
    port_fig.savefig(tmp_path / "port.png", dpi=150)
    assert read_png(tmp_path / "port.png").shape[:2] == read_png(tmp_path / "mpl.png").shape[:2]
    plt.close(mpl_fig)


def test_plot_dia_cycle(small_run, tmp_path):
    dia, _, _ = small_run
    assert (dia.cycle[0, :, 0, 0] < 0).any()  # an MS1 slot: the grey band and its text
    assert_same_figure(jax_plotting.plot_dia_cycle(dia), port_plotting.plot_dia_cycle(diadata_from_jax(dia)), tmp_path)


@pytest.mark.parametrize("kf, zero_template", [(4, False), (12, False), (4, True)])
def test_plot_fragment_profiles(tmp_path, kf, zero_template):
    rng = np.random.default_rng(kf)
    dense = (rng.random((kf, 3, 16)) * 1e4).astype(np.float32)
    template = np.zeros((3, 16), np.float32) if zero_template else rng.random((3, 16)).astype(np.float32)
    template[1] = 0.0  # one observation without a template line
    mz = (300.0 + 50.0 * np.arange(kf)).astype(np.float32)
    mask = np.arange(kf) % 3 != 2
    assert_same_figure(
        jax_plotting.plot_fragment_profiles(dense, template, mz, mask, title="test"),
        port_plotting.plot_fragment_profiles(dense, template, mz, mask, title="test"),
        tmp_path,
    )


def test_plot_precursor_profiles(tmp_path):
    dense = (np.random.default_rng(5).random((3, 32)) * 5e4).astype(np.float32)
    iso = np.array([542.084, 542.586, 543.087], np.float32)
    assert_same_figure(
        jax_plotting.plot_precursor_profiles(dense, iso, title="precursor 1 isotopes"),
        port_plotting.plot_precursor_profiles(dense, iso, title="precursor 1 isotopes"),
        tmp_path,
    )


def test_plot_selection_score(tmp_path):
    score = np.random.default_rng(2).random(32)
    assert_same_figure(
        jax_plotting.plot_selection_score(score, [10, 20], [(8, 12), (18, 23)], title="sel"),
        port_plotting.plot_selection_score(score, [10, 20], [(8, 12), (18, 23)], title="sel"),
        tmp_path,
    )


def _capture(module, monkeypatch):
    got = {"fragments": [], "precursor": []}
    frag_fn, prec_fn = module.plot_fragment_profiles, module.plot_precursor_profiles

    def frag(dense, template, mz, mask, title=""):
        got["fragments"].append((np.asarray(dense), np.asarray(template), np.asarray(mz), np.asarray(mask), title))
        return frag_fn(dense, template, mz, mask, title=title)

    def prec(dense, mz, title=""):
        got["precursor"].append((np.asarray(dense), np.asarray(mz), title))
        return prec_fn(dense, mz, title=title)

    monkeypatch.setattr(module, "plot_fragment_profiles", frag)
    monkeypatch.setattr(module, "plot_precursor_profiles", prec)
    return got


def test_debug_candidates_matches_jax(small_run, tmp_path, monkeypatch):
    dia, prec, frag = small_run
    cands = CandidateSelection(dia, prec, frag, SelectionConfig(rt_tolerance=40.0, batch_size=64))()
    cfg = ScoringConfig(batch_size=64)
    jax_got = _capture(jax_plotting, monkeypatch)
    port_got = _capture(port_plotting, monkeypatch)
    n = 8
    jax_names = jax_plotting.debug_candidates(CandidateScoring(dia, prec, frag, cfg), cands, n=n, figure_dir=tmp_path / "jax")
    scoring = PortScoring(
        diadata_from_jax(dia), frame_from_pandas(prec), frame_from_pandas(frag), config_from_jax(cfg), device="cpu"
    )
    port_names = port_plotting.debug_candidates(scoring, frame_from_pandas(cands), n=n, figure_dir=tmp_path / "port")
    assert port_names == jax_names and len(port_names) == 2 * n
    assert len(port_got["fragments"]) == len(jax_got["fragments"]) == n
    drawn = 0
    for (jd, jt, jm, jk, jtitle), (pd_, pt, pm, pk, ptitle) in zip(jax_got["fragments"], port_got["fragments"]):
        assert ptitle == jtitle and pd_.shape == jd.shape and pt.shape == jt.shape
        np.testing.assert_allclose(pd_, jd, rtol=RTOL, atol=ATOL)
        assert_close_to_peak(pt, jt)
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_array_equal(pk, jk)
        drawn += jd.max() > 0
    assert drawn >= n // 2  # the candidates' traces are not all empty
    for (jd, jm, jtitle), (pd_, pm, ptitle) in zip(jax_got["precursor"], port_got["precursor"]):
        assert ptitle == jtitle
        assert_close_to_peak(pd_, jd)
        np.testing.assert_array_equal(pm, jm)
    jax_files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == jax_files
    for name in jax_files:
        assert read_png(tmp_path / "port" / name).shape[:2] == read_png(tmp_path / "jax" / name).shape[:2]
    assert port_plotting.debug_candidates(scoring, {k: v[:0] for k, v in frame_from_pandas(cands).items()}) == []
