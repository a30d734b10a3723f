"""The port's figure layer (``alphadia_torch/reporting/figure.py``) against
matplotlib, which the card machine lacks:

- the pixel size of ``savefig`` equals matplotlib's at the same figsize
  and dpi (the sizes the package's figures use, and odd ones);
- the colour cycle equals ``rcParams["axes.prop_cycle"]`` and advances as
  matplotlib's does (a call that names a colour takes none);
- ``hist(histtype="step")`` of several data sets takes matplotlib's edges,
  counts and outline vertices (an empty set and a set of one value too);
- autoscaled limits equal matplotlib's for lines, step histograms, bars
  and spans;
- a line's pixels land in the rows and columns its data maps to, dashed
  lines leave gaps, spans and bars fill their boxes, and text draws.
"""

import matplotlib
import numpy as np
import pytest

from alphadia_torch.reporting.figure import TAB10, Figure, nice_ticks, subplots, text_bitmap, to_rgb
from alphadia_torch.utils.png import read_png

matplotlib.use("Agg")
import matplotlib.colors as mcolors  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

pytest_plugins = ("torch_port_plugin",)


@pytest.mark.parametrize(
    "figsize, dpi",
    [((9, 3.5), 120), ((4, 3.2), 150), ((8, 3.2), 150), ((12, 3.2), 150), ((4.5, 3.2), 150), ((7, 3), 150),
     ((5, 2.8), 150), ((6.4, 4.8), 100), ((0.29, 1.01), 100), ((3.3, 2.7), 72)],
)
def test_pixel_size_equals_matplotlib(tmp_path, figsize, dpi):
    fig, ax = plt.subplots(figsize=figsize)
    ax.plot([0, 1], [0, 1])
    fig.savefig(tmp_path / "mpl.png", dpi=dpi)
    plt.close(fig)
    ours, ax2 = subplots(figsize=figsize)
    ax2.plot([0, 1], [0, 1])
    ours.savefig(tmp_path / "port.png", dpi=dpi)
    assert read_png(tmp_path / "port.png").shape[:2] == read_png(tmp_path / "mpl.png").shape[:2]
    assert ours.pixel_size(dpi) == read_png(tmp_path / "mpl.png").shape[1::-1]


def test_colour_cycle_equals_matplotlib():
    assert list(TAB10) == [c["color"] for c in plt.rcParams["axes.prop_cycle"]]
    fig, ax = plt.subplots()
    ours, oax = subplots()
    calls = [
        ("plot", {}), ("plot", {"color": "#4878d0"}), ("plot", {}), ("fmt", {}), ("hist", {}),
        ("axvline", {"color": "#d65f5f"}), ("plot", {}),
    ] + [("plot", {})] * 9
    mpl_colors, port_colors = [], []
    for kind, kw in calls:
        if kind == "plot":
            mpl_colors.append(ax.plot([0, 1], [1, 2], **kw)[0].get_color())
            port_colors.append(oax.plot([0, 1], [1, 2], **kw)[0]["color"])
        elif kind == "fmt":
            mpl_colors.append(ax.plot([0, 1], [1, 2], "k--")[0].get_color())
            port_colors.append(oax.plot([0, 1], [1, 2], "k--")[0]["color"])
        elif kind == "hist":
            _, _, patches = ax.hist([[1, 2, 3], [2, 3]], bins=3, histtype="step")
            mpl_colors += [mcolors.to_hex(p[0].get_edgecolor()) for p in patches]
            oax.hist([[1, 2, 3], [2, 3]], bins=3, histtype="step")
            port_colors += [p["color"] for p in oax.primitives[-2:][::-1]]  # added last set first
        else:
            mpl_colors.append(ax.axvline(1, **kw).get_color())
            port_colors.append(oax.axvline(1, **kw)["color"])
    plt.close(fig)
    assert [mcolors.to_hex(c) for c in mpl_colors] == [mcolors.to_hex(to_rgb(c)) for c in port_colors]


@pytest.mark.parametrize(
    "data",
    [
        "two_sets",
        "empty_decoys",
        "one_value",
        "all_empty",
    ],
)
def test_step_histogram_equals_matplotlib(data):
    rng = np.random.default_rng(4)
    sets = {
        "two_sets": [rng.beta(5, 2, 3000), rng.beta(2, 5, 700)],
        "empty_decoys": [rng.random(100), np.array([])],
        "one_value": [np.full(20, 0.37), np.full(3, 0.37)],
        "all_empty": [np.array([]), np.array([])],
    }[data]
    fig, ax = plt.subplots()
    n, bins, patches = ax.hist(sets, bins=50, label=["target", "decoy"], histtype="step")
    ours, oax = subplots()
    on, obins = oax.hist(sets, bins=50, label=["target", "decoy"], histtype="step")
    np.testing.assert_array_equal(obins, bins)
    np.testing.assert_array_equal(np.asarray(on), np.asarray(n))
    steps = [p for p in oax.primitives if p["kind"] == "step"]
    assert [s["label"] for s in steps] == [p.get_label() for p in ax.patches] == ["decoy", "target"]
    for s, p, label in zip(steps[::-1], patches, ["target", "decoy"]):
        xy = p[0].get_xy()[: len(s["x"])]  # matplotlib's polygon closes on its first vertex
        np.testing.assert_array_equal(s["x"], xy[:, 0])
        np.testing.assert_array_equal(s["y"], xy[:, 1])
        assert s["label"] == p[0].get_label() == label
    np.testing.assert_allclose(oax.get_ylim(), ax.get_ylim(), rtol=1e-12)
    np.testing.assert_allclose(oax.get_xlim(), ax.get_xlim(), rtol=1e-12)
    plt.close(fig)
    assert ours.render(50).shape == (240, 320, 4)


def test_autoscaled_limits_equal_matplotlib():
    rng = np.random.default_rng(1)
    fig, axes = plt.subplots(1, 4, sharey=True)
    ours, oaxes = subplots(1, 4, sharey=True)
    x = np.arange(40)
    y0 = rng.random(40) * 1e4
    for a in (axes[0], oaxes[0]):
        a.plot(x, y0)
    y1 = np.exp(-((x - 20) ** 2) / 20) * 5e3
    for a in (axes[1], oaxes[1]):
        a.plot(x, y1, "k--", lw=2)
    for a in (axes[2], oaxes[2]):
        a.barh(2, 25, left=400, height=0.8, color="#4878d0", alpha=0.7)
        a.barh(3, 25, left=425, height=0.8, color="#4878d0", alpha=0.7)
        a.axhspan(-0.4, 0.4, color="#999", alpha=0.25)
    for a in (axes[3], oaxes[3]):
        a.plot(np.arange(64), np.sin(np.arange(64) / 6), lw=1.2)
        a.axvline(10, color="#d65f5f", lw=1)
        a.axvspan(8, 12, color="#d65f5f", alpha=0.12)
    for a, o in zip(axes, oaxes):
        np.testing.assert_allclose(o.get_xlim(), a.get_xlim(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(o.get_ylim(), a.get_ylim(), rtol=1e-12, atol=1e-12)
    axes[3].set_xlim(0, 0.05)
    oaxes[3].set_xlim(0, 0.05)
    assert oaxes[3].get_xlim() == axes[3].get_xlim()
    plt.close(fig)


def _colour_pixels(img, color, tol=40):
    rgb = np.asarray(to_rgb(color)) * 255
    return np.abs(img[..., :3].astype(np.int32) - rgb).max(axis=2) <= tol


def test_lines_land_where_their_data_maps():
    fig, ax = subplots(figsize=(6, 4))
    ax.plot([0, 10], [2.5, 2.5], color="#d62728", lw=1.5)
    ax.axvline(7.5, color="#2ca02c", lw=1.5)
    ax.plot([0, 10], [0, 5], alpha=0.0)  # sets the limits, draws nothing
    img = fig.render(100)
    (x0, y0, x1, y1), (xl, yl) = ax.box, (ax.get_xlim(), ax.get_ylim())
    row = y1 - (2.5 - yl[0]) / (yl[1] - yl[0]) * (y1 - y0)
    col = x0 + (7.5 - xl[0]) / (xl[1] - xl[0]) * (x1 - x0)
    lw = 1.5 * 100 / 72
    rows, cols = np.nonzero(_colour_pixels(img, "#d62728", tol=10))
    assert rows.size and np.abs(rows + 0.5 - row).max() <= lw / 2 + 1
    assert cols.min() >= x0 - 1 and cols.max() <= x1 + 1  # clipped to the axes
    assert cols.max() - cols.min() >= (x1 - x0) * 0.85  # from x=0 to x=10, inside the margins
    rows, cols = np.nonzero(_colour_pixels(img, "#2ca02c", tol=10))
    assert cols.size and np.abs(cols + 0.5 - col).max() <= lw / 2 + 1
    assert rows.min() <= y0 + 2 and rows.max() >= y1 - 2  # the axes' full height


def test_dashes_spans_and_bars_draw():
    fig, ax = subplots(figsize=(6, 4))
    ax.plot([0, 10], [1, 1], "k--", lw=2)
    ax.axvspan(2, 4, color="#d65f5f", alpha=1.0)
    ax.barh(3, 2, left=6, height=0.8, color="#4878d0")
    ax.axhspan(4.6, 5.0, color="#999")
    img = fig.render(100)
    x0, y0, x1, y1 = ax.box
    xl, yl = ax.get_xlim(), ax.get_ylim()

    def px(v):
        return x0 + (v - xl[0]) / (xl[1] - xl[0]) * (x1 - x0)

    def py(v):
        return y1 - (v - yl[0]) / (yl[1] - yl[0]) * (y1 - y0)

    dark = (img[..., :3].max(axis=2) < 60)[int(py(1))]
    inside = dark[int(px(4.5)):int(px(9.5))]
    assert 0.3 < inside.mean() < 0.9  # dashes: ink and gaps
    span = _colour_pixels(img, "#d65f5f", tol=3)
    assert span[int(py(2.0)), int(px(3.0))] and not span[int(py(2.0)), int(px(5.0))]
    bar = _colour_pixels(img, "#4878d0", tol=3)
    assert bar[int(py(3.0)), int(px(7.0))] and not bar[int(py(2.0)), int(px(7.0))]
    grey = _colour_pixels(img, "#999", tol=3)
    assert grey[int(py(4.8)), int((x0 + x1) / 2)]


def test_text_draws():
    blank, _ = subplots(figsize=(4, 3))
    titled, ax = subplots(figsize=(4, 3))
    ax.set_title("precursor 12 isotopes", fontsize=9)
    ax.set_xlabel("cycle (window)")
    ax.set_ylabel("intensity")
    a, b = blank.render(150), titled.render(150)
    changed = np.nonzero((a != b).any(axis=2))
    assert changed[0].size > 500
    top_rows = changed[0] < ax.box[1]
    assert top_rows.any()  # the title above the plot
    assert (changed[1] < ax.box[0]).any()  # the y label left of it
    h, w = text_bitmap("mm", 20.0)[0].shape
    assert text_bitmap("mmmm", 20.0)[0].shape[1] > 1.8 * w - 4 and h >= 20
    assert text_bitmap("µ ok", 20.0)[0].max() > 0.9  # outside ASCII: a stand-in glyph


def test_ticks_and_errors():
    np.testing.assert_allclose(nice_ticks(0, 0.05, 5), [0, 0.01, 0.02, 0.03, 0.04, 0.05])
    np.testing.assert_allclose(nice_ticks(-0.3, 9.7, 4), [0, 5])
    fig = Figure()
    ax = fig.subplots()
    with pytest.raises(ValueError, match="histtype"):
        ax.hist([1, 2, 3], histtype="bar")
    with pytest.raises(ValueError, match="format"):
        ax.plot([1, 2], [1, 2], "o")
    with pytest.raises(ValueError, match="colour"):
        to_rgb("not a colour")
    with pytest.raises(ValueError, match="already"):
        fig.subplots()
