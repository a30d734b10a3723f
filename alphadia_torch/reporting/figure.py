"""The port's figure layer: the subset of matplotlib's API that the
package's plots call, drawn by numpy and written as PNG (``utils/png``).
The card machine has no matplotlib and no PIL.

Each plotting call records its primitive (data, colour, line style,
label) in ``Axes.primitives``, as a dict that names its kind:

- ``line``: ``plot`` (``x``, ``y``; ``axvline`` records one with
  ``coords="xaxis"``: x in data, y in axes coordinates);
- ``step``: one per data set of ``hist(histtype="step")``: the outline's
  vertices ``x``, ``y`` as matplotlib's polygon holds them, the ``edges``
  and ``counts``;
- ``rect``: ``barh`` (``coords="data"``), ``axhspan`` (``"yaxis"``: x in
  axes, y in data coordinates) and ``axvspan`` (``"xaxis"``), each with
  matplotlib's ``x``, ``y``, ``width`` and ``height``;
- ``text``: ``text`` with its ``coords`` (``"data"``, or ``"yaxis"`` for
  ``transform=ax.get_yaxis_transform()``).

``Figure.savefig`` draws from that list. The pixel size is matplotlib's:
``int(figsize * dpi)``. The data, the colours (matplotlib's default cycle,
``tab10``, per axes, advanced only by a call that names no colour), the
histogram's edges (one set over every data set, as matplotlib takes them)
and the limits that autoscaling gives (the data's range, 5% margins, the
histogram's and the bars' sticky edges) follow matplotlib. Tick positions
(steps of 1, 2 and 5), the layout, the legend's place and the look are the
port's own.

Rasterising is vectorised: rectangles and spans by their exact pixel
coverage, lines (solid or dashed) by samples along them on a grid
``SUPERSAMPLE`` times finer, widened by a disc of the line's width and
averaged back, text from the committed bitmap of DejaVu Sans (``font/``)
resampled to its size. Anything outside this subset raises.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

from alphadia_torch.utils.png import write_png

TAB10 = (
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
)
# matplotlib's base colours (the one-letter names)
BASE_COLORS = {
    "b": (0.0, 0.0, 1.0), "g": (0.0, 0.5, 0.0), "r": (1.0, 0.0, 0.0), "c": (0.0, 0.75, 0.75),
    "m": (0.75, 0.0, 0.75), "y": (0.75, 0.75, 0.0), "k": (0.0, 0.0, 0.0), "w": (1.0, 1.0, 1.0),
}
# on / off lengths of matplotlib's dash patterns, in line widths
DASHES = {"-": None, "--": (3.7, 1.6)}
FONT_SIZE = 10.0  # points: tick labels, axis labels, legend, text
TITLE_SIZE = 12.0  # points: titles and the suptitle ("large")
LINE_WIDTH = 1.5  # points: plot
PATCH_WIDTH = 1.0  # points: the histogram's outline
SPINE_WIDTH = 0.8  # points: the frame and the ticks
TICK_LENGTH = 3.5  # points
MARGIN = 0.05  # autoscale margin, a share of the data's range each side
SUPERSAMPLE = 3
ZORDER = {"rect": 1, "line": 2, "step": 2, "text": 3}
FONT_DIR = Path(__file__).parent / "font"


def to_rgb(color) -> tuple:
    """(r, g, b) in [0, 1] of a matplotlib colour: ``#rgb``, ``#rrggbb``, a
    base colour letter or an RGB tuple."""
    if isinstance(color, tuple) and len(color) == 3:
        return tuple(float(c) for c in color)
    if not isinstance(color, str):
        raise ValueError(f"colour {color!r} is not understood")
    if color in BASE_COLORS:
        return BASE_COLORS[color]
    h = color[1:] if color.startswith("#") else ""
    if len(h) == 3:
        h = "".join(c * 2 for c in h)
    if len(h) == 6:
        try:
            return tuple(int(h[i:i + 2], 16) / 255.0 for i in (0, 2, 4))
        except ValueError:
            pass
    raise ValueError(f"colour {color!r} is not understood")


def _parse_fmt(fmt: str) -> tuple:
    """(colour or None, line style) of a plot format such as ``"k--"``."""
    style = "--" if fmt.endswith("--") else "-" if fmt.endswith("-") else ""
    color = fmt[: len(fmt) - len(style)] or None
    if color is not None and color not in BASE_COLORS:
        raise ValueError(f"plot format {fmt!r} is not understood (a colour letter and '-' or '--')")
    return color, style or "-"


# ---------------------------------------------------------------------------
# the font
# ---------------------------------------------------------------------------
@lru_cache(maxsize=1)
def _font() -> dict:
    with np.load(FONT_DIR / "dejavu_sans.npz") as f:
        return {k: f[k] for k in f.files}


def _resample_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] box-filter weights that shrink (or grow) n_in pixels to n_out."""
    s = n_out / n_in
    lo = np.arange(n_out)[:, None] / s
    i = np.arange(n_in)[None, :]
    w = np.clip(np.minimum(i + 1, lo + 1 / s) - np.maximum(i, lo), 0.0, None)
    return w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)


@lru_cache(maxsize=512)
def text_bitmap(s: str, size_px: float) -> tuple:
    """(coverage f32[h, w] in [0, 1], the baseline's row) of ``s`` drawn at
    ``size_px`` pixels an em."""
    f = _font()
    codes = np.frombuffer(s.encode("ascii", errors="replace"), np.uint8).astype(np.int64)
    codes = np.where((codes < 32) | (codes > 126), ord("?"), codes) - 32
    adv = f["advance"][codes].astype(np.float64)
    pens = np.round(np.concatenate([[0.0], np.cumsum(adv)[:-1]])).astype(np.int64)
    widths = f["width"][codes].astype(np.int64)
    total = int((pens + widths).max()) if len(s) else 1
    rows = int(f["ascent"] + f["descent"])
    img = np.zeros((rows, total), np.float32)
    alpha = f["alpha"]
    for pen, c, w in zip(pens, codes, widths):  # one glyph cell a character
        left = int(f["left"][c])
        np.maximum(img[:, pen:pen + w], alpha[:, left:left + w] / np.float32(255), out=img[:, pen:pen + w])
    scale = size_px / float(f["em"])
    h_out = max(1, int(round(rows * scale)))
    w_out = max(1, int(round(total * scale)))
    out = _resample_matrix(rows, h_out) @ img @ _resample_matrix(total, w_out).T
    return np.clip(out, 0.0, 1.0).astype(np.float32), float(f["ascent"]) * scale


# ---------------------------------------------------------------------------
# rasterising
# ---------------------------------------------------------------------------
class Canvas:
    """RGB uint8 over white; every draw blends colour by coverage."""

    def __init__(self, width: int, height: int):
        self.width, self.height = width, height
        self.rgb = np.full((height, width, 3), 255, np.uint8)

    def blend(self, cover: np.ndarray, r0: int, c0: int, color, alpha: float = 1.0) -> None:
        """Blend ``color`` at ``alpha`` by ``cover`` [h, w] placed at row r0, column c0 (clipped)."""
        h, w = cover.shape
        ra, ca = max(r0, 0), max(c0, 0)
        rb, cb = min(r0 + h, self.height), min(c0 + w, self.width)
        if ra >= rb or ca >= cb:
            return
        k = cover[ra - r0:rb - r0, ca - c0:cb - c0, None] * np.float32(alpha)
        region = self.rgb[ra:rb, ca:cb]
        mixed = region * (1 - k) + k * (np.asarray(to_rgb(color), np.float32) * np.float32(255))
        region[...] = mixed + np.float32(0.5)  # in [0, 255]: rounds

    def rect(self, x0, y0, x1, y1, color, alpha=1.0, clip=None) -> None:
        """Fill [x0, x1] x [y0, y1] (pixels, fractional) by exact coverage."""
        if clip is not None:
            x0, x1 = max(x0, clip[0]), min(x1, clip[2])
            y0, y1 = max(y0, clip[1]), min(y1, clip[3])
        if not (x1 > x0 and y1 > y0) or not np.isfinite([x0, x1, y0, y1]).all():
            return
        c0, c1 = int(np.floor(x0)), int(np.ceil(x1))
        r0, r1 = int(np.floor(y0)), int(np.ceil(y1))
        cols = np.arange(c0, c1)
        rows = np.arange(r0, r1)
        cx = np.clip(np.minimum(x1, cols + 1) - np.maximum(x0, cols), 0, 1)
        cy = np.clip(np.minimum(y1, rows + 1) - np.maximum(y0, rows), 0, 1)
        self.blend((cy[:, None] * cx[None, :]).astype(np.float32), r0, c0, color, alpha)

    def polyline(self, px, py, lw_px, color, alpha=1.0, dashes=None, clip=None) -> None:
        """Draw the polyline through (px, py) (pixels; a non-finite point
        breaks it), ``lw_px`` wide, solid or with on/off ``dashes`` in
        pixels, clipped to ``clip`` = (x0, y0, x1, y1)."""
        x0, y0, x1, y1 = clip if clip is not None else (0, 0, self.width, self.height)
        x0, y0 = int(np.floor(x0)), int(np.floor(y0))
        x1, y1 = int(np.ceil(x1)), int(np.ceil(y1))
        cover = line_cover(np.asarray(px, np.float64) - x0, np.asarray(py, np.float64) - y0, x1 - x0, y1 - y0,
                           lw_px, dashes)
        if cover is not None:
            self.blend(cover[0], y0 + cover[1], x0 + cover[2], color, alpha)

    def text(self, x, y, s, size_px, ha="left", va="baseline", vertical=False) -> None:
        """Draw ``s`` in black anchored at (x, y): ``ha`` and ``va`` place
        its box; ``vertical`` turns it to read upwards (centred on y)."""
        cover, base = text_bitmap(s, round(size_px, 2))
        if vertical:
            cover, base, va = np.rot90(cover), 0.0, "center"
        ch, cw = cover.shape
        left = {"left": x, "center": x - cw / 2, "right": x - cw}[ha]
        top = {"top": y, "center": y - ch / 2, "bottom": y - ch, "baseline": y - base}[va]
        self.blend(cover, int(round(top)), int(round(left)), "k")

    def rgba(self) -> np.ndarray:
        out = np.empty((self.height, self.width, 4), np.uint8)
        out[..., :3] = self.rgb
        out[..., 3] = 255
        return out


def line_cover(px, py, width: int, height: int, lw_px: float, dashes=None):
    """(coverage f32[h, w], its first row, its first column) of a polyline
    of width ``lw_px`` through (px, py) (pixels) inside the box
    [0, width) x [0, height), or None where nothing of it lies there."""
    ss = SUPERSAMPLE
    if len(px) < 2 or width <= 0 or height <= 0:
        return None
    r = max(lw_px * ss / 2, 0.5)
    ax, ay = px[:-1] * ss, py[:-1] * ss
    bx, by = px[1:] * ss, py[1:] * ss
    ok = np.isfinite(ax) & np.isfinite(ay) & np.isfinite(bx) & np.isfinite(by)
    dx, dy = bx - ax, by - ay
    seg = np.where(ok, np.hypot(dx, dy), 0.0)
    arc0 = np.concatenate([[0.0], np.cumsum(seg)[:-1]])  # arc length at each segment's start
    # Liang-Barsky: each segment's part inside the box grown by the radius
    lo_x, hi_x, lo_y, hi_y = -r, width * ss + r, -r, height * ss + r
    t0 = np.zeros_like(seg)
    t1 = np.ones_like(seg)
    with np.errstate(divide="ignore", invalid="ignore"):
        for p, q in ((-dx, ax - lo_x), (dx, hi_x - ax), (-dy, ay - lo_y), (dy, hi_y - ay)):
            ok &= ~((p == 0) & (q < 0))
            t = q / p
            t0 = np.where(p < 0, np.maximum(t0, t), t0)
            t1 = np.where(p > 0, np.minimum(t1, t), t1)
    ok &= t0 <= t1
    idx = np.flatnonzero(ok)
    if not idx.size:
        return None
    t0, t1 = t0[idx], t1[idx]
    step = min(1.0, r)  # fine pixels between samples: the disc of radius r leaves no gap
    n = np.ceil((t1 - t0) * seg[idx] / step).astype(np.int64) + 1
    first = np.cumsum(n) - n
    which = np.repeat(np.arange(idx.size), n)
    k = np.arange(int(n.sum())) - first[which]
    t = t0[which] + (t1 - t0)[which] * (k / np.maximum(n[which] - 1, 1))
    s = idx[which]
    x = ax[s] + t * dx[s]
    y = ay[s] + t * dy[s]
    if dashes:
        period = np.cumsum(np.asarray(dashes, np.float64) * ss)
        phase = (arc0[s] + t * seg[s]) % period[-1]
        on = np.searchsorted(period, phase, side="right") % 2 == 0
        x, y = x[on], y[on]
    W, H = width * ss, height * ss
    rr = int(np.ceil(r))
    off = rr + 1  # the samples lie within r of the box: shift them to non-negative indices
    stride = W + 2 * off
    pix = np.unique((np.floor(y).astype(np.int64) + off) * stride + np.floor(x).astype(np.int64) + off)
    iy, ix = np.divmod(pix, stride)
    iy -= off
    ix -= off
    oy, ox = np.mgrid[-rr:rr + 1, -rr:rr + 1]
    disc = (ox**2 + oy**2) <= r * r
    oy, ox = oy[disc], ox[disc]
    yy = (iy[:, None] + oy[None, :]).ravel()
    xx = (ix[:, None] + ox[None, :]).ravel()
    inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    if not inside.any():
        return None
    yy, xx = yy[inside], xx[inside]
    # the mask covers the drawn pixels' bounding box only
    r0, c0 = int(yy.min()) // ss, int(xx.min()) // ss
    h, w = int(yy.max()) // ss - r0 + 1, int(xx.max()) // ss - c0 + 1
    mask = np.zeros(h * ss * w * ss, np.uint8)
    mask[(yy - r0 * ss) * (w * ss) + (xx - c0 * ss)] = 1
    counts = mask.reshape(h, ss, w * ss).sum(axis=1, dtype=np.uint8).reshape(h, w, ss).sum(axis=2, dtype=np.uint8)
    return counts.astype(np.float32) / np.float32(ss * ss), r0, c0


# ---------------------------------------------------------------------------
# ticks and limits
# ---------------------------------------------------------------------------
def nice_ticks(lo: float, hi: float, n_target: int) -> np.ndarray:
    """Ticks in [lo, hi] on a step of 1, 2 or 5 times a power of ten, about
    ``n_target`` of them."""
    span = hi - lo
    if not np.isfinite(span) or span <= 0:
        return np.array([lo])
    raw = span / max(n_target, 1)
    mag = 10.0 ** np.floor(np.log10(raw))
    step = next(m * mag for m in (1, 2, 5, 10) if m * mag >= raw * (1 - 1e-9))
    first = np.ceil(lo / step - 1e-9)
    last = np.floor(hi / step + 1e-9)
    return np.arange(first, last + 1) * step


def tick_labels(ticks: np.ndarray) -> list:
    if len(ticks) < 2:
        return [f"{t:g}" for t in ticks]
    step = float(np.min(np.diff(ticks)))
    big = float(np.max(np.abs(ticks)))
    if big >= 1e5 or step < 1e-4:
        return [("0" if t == 0 else f"{t:.3g}") for t in ticks]
    dec = max(0, -int(np.floor(np.log10(step) + 1e-9)))
    out = []
    for t in ticks:
        lab = f"{t:.{dec}f}"
        out.append("0" if float(lab) == 0 else lab)
    return out


def _nonsingular(lo: float, hi: float) -> tuple:
    if not (np.isfinite(lo) and np.isfinite(hi)):
        return 0.0, 1.0
    if hi - lo <= max(abs(lo), abs(hi)) * 1e-15:
        if lo == 0 and hi == 0:
            return -0.05, 0.05
        return lo - 0.05 * abs(lo), hi + 0.05 * abs(hi)
    return lo, hi


def _autoscale(extents: list, sticky: list) -> tuple:
    """matplotlib's autoscale of one axis: the data's range with MARGIN each
    side, not past a sticky edge at the data's bound."""
    lo = min((e[0] for e in extents), default=np.inf)
    hi = max((e[1] for e in extents), default=-np.inf)
    if not (np.isfinite(lo) and np.isfinite(hi)):
        return 0.0, 1.0
    lo, hi = _nonsingular(lo, hi)
    sticky = np.asarray(sticky, np.float64)
    tol = 1e-5 * (hi - lo)
    below = sticky[sticky <= lo + tol]
    above = sticky[sticky >= hi - tol]
    lo_bound = below.max() if below.size else -np.inf
    hi_bound = above.min() if above.size else np.inf
    delta = (hi - lo) * MARGIN
    return max(lo - delta, lo_bound), min(hi + delta, hi_bound)


def _extent(values) -> tuple | None:
    v = np.asarray(values, np.float64)
    v = v[np.isfinite(v)]
    return (float(v.min()), float(v.max())) if v.size else None


# ---------------------------------------------------------------------------
# figure and axes
# ---------------------------------------------------------------------------
class Axes:
    """One plot of a :class:`Figure` (the matplotlib calls the package uses)."""

    def __init__(self, figure: Figure, row: int, col: int):
        self.figure = figure
        self.row, self.col = row, col
        self.primitives: list[dict] = []
        self.title = ""
        self.title_fontsize = None
        self.xlabel = ""
        self.ylabel = ""
        self.xlim = None  # set_xlim's (left, right); None autoscales
        self.legend_fontsize = None  # legend() called: its font size in points
        self.sharey: list[Axes] = [self]
        self.show_ytick_labels = True
        self._cycle = 0
        self.box = None  # (x0, y0, x1, y1) pixels of the last render

    # -- the colour cycle -----------------------------------------------------
    def _next_color(self) -> str:
        c = TAB10[self._cycle % len(TAB10)]
        self._cycle += 1
        return c

    # -- plotting -------------------------------------------------------------
    def plot(self, x, y, fmt=None, *, color=None, lw=LINE_WIDTH, alpha=1.0, label=None) -> list:
        style = "-"
        if fmt is not None:
            fmt_color, style = _parse_fmt(fmt)
            color = color if color is not None else fmt_color
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        if x.shape != y.shape:
            raise ValueError(f"x and y must have the same length, got {x.size} and {y.size}")
        p = {
            "kind": "line", "coords": "data", "x": x, "y": y,
            "color": color if color is not None else self._next_color(),
            "alpha": float(alpha), "lw": float(lw), "ls": style, "label": None if label is None else str(label),
        }
        self.primitives.append(p)
        return [p]

    def hist(self, x: list, bins=10, *, label=None, histtype="bar"):
        """``histtype="step"`` of a list of data sets only: one outline a
        data set, over one set of edges taken from every data set together
        (matplotlib's rule)."""
        if histtype != "step":
            raise ValueError(f"hist draws histtype='step' only, got {histtype!r}")
        # each data set keeps its dtype: numpy takes the edges' dtype from it
        arrays = [np.asarray(a).ravel() for a in x]
        seen = [a for a in arrays if a.size]
        rng = (min(np.nanmin(a) for a in seen), max(np.nanmax(a) for a in seen)) if seen else None
        if rng is not None and not rng[0] <= rng[1]:
            rng = None  # only NaN
        if seen and len(arrays) > 1:
            edges = np.histogram_bin_edges(np.concatenate(arrays), bins, rng)
        else:
            edges = np.histogram_bin_edges(arrays[0], bins, rng)
        labels = list(label) if label is not None else []
        labels += [None] * (len(arrays) - len(labels))
        colors = [self._next_color() for _ in arrays]
        counts_all = [np.histogram(a, edges)[0].astype(np.float64) for a in arrays]
        # the outlines join the axes last data set first, as matplotlib adds them
        for counts, lab, col in reversed(list(zip(counts_all, labels, colors))):
            n = len(edges)
            xs = np.empty(2 * n)
            ys = np.zeros(2 * n)
            xs[0::2], xs[1::2] = edges, edges
            ys[1:-1:2], ys[2:-1:2] = counts, counts
            self.primitives.append({
                "kind": "step", "coords": "data", "x": xs, "y": ys, "edges": edges, "counts": counts,
                "color": col, "alpha": 1.0, "lw": PATCH_WIDTH, "ls": "-", "label": lab,
            })
        return counts_all, edges

    def barh(self, y, width, height=0.8, left=0.0, *, color=TAB10[0], alpha=1.0):
        p = {"kind": "rect", "coords": "data", "x": float(left), "y": float(y - height / 2), "width": float(width),
             "height": float(height), "color": color, "alpha": float(alpha), "sticky_x": float(left)}
        self.primitives.append(p)
        return p

    def axhspan(self, ymin, ymax, *, color=TAB10[0], alpha=1.0):
        p = {"kind": "rect", "coords": "yaxis", "x": 0.0, "y": float(ymin), "width": 1.0,
             "height": float(ymax - ymin), "color": color, "alpha": float(alpha)}
        self.primitives.append(p)
        return p

    def axvspan(self, xmin, xmax, *, color=TAB10[0], alpha=1.0):
        p = {"kind": "rect", "coords": "xaxis", "x": float(xmin), "y": 0.0, "width": float(xmax - xmin),
             "height": 1.0, "color": color, "alpha": float(alpha)}
        self.primitives.append(p)
        return p

    def axvline(self, x, *, color=None, lw=LINE_WIDTH):
        p = {"kind": "line", "coords": "xaxis", "x": np.array([float(x), float(x)]), "y": np.array([0.0, 1.0]),
             "color": color if color is not None else self._next_color(), "alpha": 1.0, "lw": float(lw),
             "ls": "-", "label": None}
        self.primitives.append(p)
        return p

    def get_yaxis_transform(self) -> str:
        """Blended coordinates for ``text``: x in axes, y in data coordinates."""
        return "yaxis"

    def text(self, x, y, s, *, va="baseline", ha="left", transform=None):
        if transform not in (None, "yaxis"):
            raise ValueError(f"text transform {transform!r} is not understood")
        p = {"kind": "text", "coords": transform or "data", "x": float(x), "y": float(y), "s": str(s), "va": va,
             "ha": ha}
        self.primitives.append(p)
        return p

    def set_xlabel(self, label):
        self.xlabel = str(label)

    def set_ylabel(self, label):
        self.ylabel = str(label)

    def set_title(self, label, fontsize=None):
        self.title = str(label)
        self.title_fontsize = fontsize

    def set_xlim(self, left, right):
        self.xlim = (float(left), float(right))

    def legend(self, fontsize=FONT_SIZE):
        self.legend_fontsize = float(fontsize)

    # -- limits -----------------------------------------------------------------
    def _data_extents(self, axis: str) -> tuple:
        extents, sticky = [], []
        for p in self.primitives:
            k, c = p["kind"], p["coords"]
            if k in ("line", "step"):
                if axis == "x" and c in ("data", "xaxis"):
                    e = _extent(p["x"])
                elif axis == "y" and c == "data":
                    e = _extent(p["y"])
                else:
                    e = None
                if k == "step" and axis == "y":
                    sticky.append(0.0)
            elif k == "rect":
                if axis == "x" and c in ("data", "xaxis"):
                    e = _extent([p["x"], p["x"] + p["width"]])
                elif axis == "y" and c in ("data", "yaxis"):
                    e = _extent([p["y"], p["y"] + p["height"]])
                else:
                    e = None
                if axis == "x" and "sticky_x" in p:
                    sticky.append(p["sticky_x"])
            else:
                e = None
            if e is not None:
                extents.append(e)
        return extents, sticky

    def get_xlim(self) -> tuple:
        if self.xlim is not None:
            return self.xlim
        return _autoscale(*self._data_extents("x"))

    def get_ylim(self) -> tuple:
        extents, sticky = [], []
        for ax in self.sharey:
            e, s = ax._data_extents("y")
            extents += e
            sticky += s
        return _autoscale(extents, sticky)

    def legend_entries(self) -> list:
        """(label, primitive) of each labelled line or outline, in order."""
        return [(p["label"], p) for p in self.primitives
                if p["kind"] in ("line", "step") and p["label"] and not p["label"].startswith("_")]


class Figure:
    """A grid of :class:`Axes` drawn to PNG at ``int(figsize * dpi)`` pixels."""

    def __init__(self, figsize=(6.4, 4.8), dpi=100):
        self.figsize = (float(figsize[0]), float(figsize[1]))
        self.dpi = float(dpi)
        self.axes: list[Axes] = []
        self.grid = (1, 1)
        self.suptitle_text = ""
        self.suptitle_fontsize = None

    def subplots(self, nrows=1, ncols=1, *, sharey=False, squeeze=True):
        if self.axes:
            raise ValueError("this figure already holds its axes")
        self.grid = (int(nrows), int(ncols))
        grid = np.empty((nrows, ncols), dtype=object)
        for r in range(nrows):
            for c in range(ncols):
                grid[r, c] = Axes(self, r, c)
                self.axes.append(grid[r, c])
        if sharey:
            for r in range(nrows):
                row = list(grid[r])
                for c, ax in enumerate(row):
                    ax.sharey = row
                    ax.show_ytick_labels = c == 0
        if squeeze:
            if nrows == ncols == 1:
                return grid[0, 0]
            if nrows == 1 or ncols == 1:
                return grid.ravel()
        return grid

    def suptitle(self, t, fontsize=None):
        self.suptitle_text = str(t)
        self.suptitle_fontsize = fontsize

    def tight_layout(self):
        """The layout always fits the text around each plot (the port's own)."""

    def pixel_size(self, dpi=None) -> tuple:
        """(width, height) in pixels at ``dpi``, as matplotlib's Agg canvas."""
        dpi = self.dpi if dpi is None else float(dpi)
        return int(self.figsize[0] * dpi), int(self.figsize[1] * dpi)

    def savefig(self, fname, dpi=None):
        write_png(fname, self.render(dpi))

    # -- drawing ---------------------------------------------------------------
    def render(self, dpi=None) -> np.ndarray:
        """uint8[H, W, 4] of the figure at ``dpi``."""
        dpi = self.dpi if dpi is None else float(dpi)
        W, H = self.pixel_size(dpi)
        canvas = Canvas(W, H)
        if not self.axes:
            return canvas.rgba()
        pt = dpi / 72.0
        pad = 4.0 * pt
        top = pad
        if self.suptitle_text:
            size = (self.suptitle_fontsize or TITLE_SIZE) * pt
            canvas.text(W / 2, top, self.suptitle_text, size, ha="center", va="top")
            top += size * 1.3 + pad
        layout = _layout(self, W, H, top, pt)
        for ax, (box, xt, yt) in zip(self.axes, layout):
            _draw_axes(canvas, ax, box, xt, yt, pt)
        return canvas.rgba()


def subplots(nrows=1, ncols=1, *, figsize=(6.4, 4.8), dpi=100, sharey=False, squeeze=True):
    """``(Figure, axes)`` as ``matplotlib.pyplot.subplots`` returns them."""
    fig = Figure(figsize, dpi)
    return fig, fig.subplots(nrows, ncols, sharey=sharey, squeeze=squeeze)


def _text_width(s: str, size_px: float) -> float:
    return text_bitmap(s, round(size_px, 2))[0].shape[1] if s else 0.0


def _axis_ticks(lo, hi, length_px, size_px, vertical) -> tuple:
    per = size_px * (2.5 if vertical else 5.0)
    ticks = nice_ticks(min(lo, hi), max(lo, hi), int(np.clip(length_px / per, 2, 8)))
    return ticks, tick_labels(ticks)


def _layout(fig: Figure, W: int, H: int, top: float, pt: float) -> list:
    """Per axes its plot box (x0, y0, x1, y1) in pixels and its ticks
    ((values, labels) on x, on y): margins from the text that each axes
    draws around its box, plots of one width a column and one height a row."""
    nrows, ncols = fig.grid
    pad = 4.0 * pt
    fs = FONT_SIZE * pt
    tick = TICK_LENGTH * pt
    cell_h = (H - top) / nrows
    boxes = []
    for ax in fig.axes:
        title_h = ((ax.title_fontsize or TITLE_SIZE) * pt * 1.3 + pad) if ax.title else 0.0
        xlabel_h = fs * 1.3 + pad if ax.xlabel else 0.0
        ylabel_w = fs * 1.3 + pad if ax.ylabel else 0.0
        boxes.append([ax, title_h, xlabel_h, ylabel_w])
    # first pass with a guess of the y tick labels' width, then measured
    ytick_w = {id(ax): 4 * fs * 0.6 for ax in fig.axes}
    result = None
    for _ in range(2):
        result = []
        lefts = {}
        for ax, title_h, xlabel_h, ylabel_w in boxes:
            left = pad + ylabel_w + (ytick_w[id(ax)] + pad if ax.show_ytick_labels else 0.0) + tick
            lefts[id(ax)] = left
        right = pad + 3 * fs * 0.6
        # every column's plot the same width
        width = (W - sum(max(lefts[id(a)] for a in fig.axes if a.col == c) for c in range(ncols)) - ncols * right) / ncols
        x = 0.0
        col_x0 = []
        for c in range(ncols):
            left = max(lefts[id(a)] for a in fig.axes if a.col == c)
            col_x0.append(x + left)
            x += left + width + right
        for ax, title_h, xlabel_h, ylabel_w in boxes:
            y_top = top + ax.row * cell_h + title_h + pad
            y_bot = top + (ax.row + 1) * cell_h - (pad + xlabel_h + fs * 1.3 + pad + tick)
            box = (col_x0[ax.col], y_top, col_x0[ax.col] + max(width, 1.0), max(y_bot, y_top + 1.0))
            xt = _axis_ticks(*ax.get_xlim(), box[2] - box[0], fs, False)
            yt = _axis_ticks(*ax.get_ylim(), box[3] - box[1], fs, True)
            ytick_w[id(ax)] = max((_text_width(s, fs) for s in yt[1]), default=0.0)
            result.append((box, xt, yt))
    return result


def _mapper(box, xlim, ylim):
    x0, y0, x1, y1 = box
    sx = (x1 - x0) / ((xlim[1] - xlim[0]) or 1.0)
    sy = (y1 - y0) / ((ylim[1] - ylim[0]) or 1.0)

    def mx(v, coords_axes=False):
        v = np.asarray(v, np.float64)
        return x0 + v * (x1 - x0) if coords_axes else x0 + (v - xlim[0]) * sx

    def my(v, coords_axes=False):
        v = np.asarray(v, np.float64)
        return y1 - v * (y1 - y0) if coords_axes else y1 - (v - ylim[0]) * sy

    return mx, my


def _draw_axes(canvas: Canvas, ax: Axes, box, xt, yt, pt: float) -> None:
    ax.box = box
    x0, y0, x1, y1 = box
    xlim, ylim = ax.get_xlim(), ax.get_ylim()
    mx, my = _mapper(box, xlim, ylim)
    fs = FONT_SIZE * pt
    order = sorted(range(len(ax.primitives)), key=lambda i: ZORDER[ax.primitives[i]["kind"]])
    for i in order:
        p = ax.primitives[i]
        k, c = p["kind"], p["coords"]
        if k == "rect":
            xa = mx([p["x"], p["x"] + p["width"]], c == "yaxis")
            ya = my([p["y"], p["y"] + p["height"]], c == "xaxis")
            canvas.rect(xa.min(), ya.min(), xa.max(), ya.max(), p["color"], p["alpha"], clip=box)
        elif k in ("line", "step"):
            lw = p["lw"] * pt
            pattern = DASHES[p["ls"]]
            dashes = None if pattern is None else [d * lw for d in pattern]
            canvas.polyline(mx(p["x"]), my(p["y"], c == "xaxis"), lw, p["color"], p["alpha"], dashes, clip=box)
        elif k == "text":
            tx, ty = mx(p["x"], c == "yaxis"), my(p["y"])
            canvas.text(float(tx), float(ty), p["s"], FONT_SIZE * pt, ha=p["ha"], va=p["va"])
    # the frame and the ticks
    sw = SPINE_WIDTH * pt
    tick = TICK_LENGTH * pt
    for a, b, c_, d in ((x0 - sw / 2, y0 - sw / 2, x1 + sw / 2, y0 + sw / 2), (x0 - sw / 2, y1 - sw / 2, x1 + sw / 2, y1 + sw / 2),
                        (x0 - sw / 2, y0, x0 + sw / 2, y1), (x1 - sw / 2, y0, x1 + sw / 2, y1)):
        canvas.rect(a, b, c_, d, "k")
    for v, lab in zip(*xt):
        px = float(mx(v))
        if x0 - 0.5 <= px <= x1 + 0.5:
            canvas.rect(px - sw / 2, y1, px + sw / 2, y1 + tick, "k")
            canvas.text(px, y1 + tick + 2 * pt, lab, fs, ha="center", va="top")
    for v, lab in zip(*yt):
        py = float(my(v))
        if y0 - 0.5 <= py <= y1 + 0.5:
            canvas.rect(x0 - tick, py - sw / 2, x0, py + sw / 2, "k")
            if ax.show_ytick_labels:
                canvas.text(x0 - tick - 2 * pt, py, lab, fs, ha="right", va="center")
    if ax.title:
        size = (ax.title_fontsize or TITLE_SIZE) * pt
        canvas.text((x0 + x1) / 2, y0 - 4 * pt, ax.title, size, ha="center", va="bottom")
    if ax.xlabel:
        canvas.text((x0 + x1) / 2, y1 + tick + 2 * pt + fs * 1.3 + 2 * pt, ax.xlabel, fs, ha="center", va="top")
    if ax.ylabel:
        left = x0 - tick - 2 * pt - (max((_text_width(s, fs) for s in yt[1]), default=0) if ax.show_ytick_labels else 0)
        canvas.text(left - 2 * pt, (y0 + y1) / 2, ax.ylabel, fs, ha="right", vertical=True)
    if ax.legend_fontsize is not None:
        _draw_legend(canvas, ax, box, mx, my, pt)


def _draw_legend(canvas: Canvas, ax: Axes, box, mx, my, pt: float) -> None:
    entries = ax.legend_entries()
    if not entries:
        return
    size = ax.legend_fontsize * pt
    row = size * 1.4
    handle = 2.0 * size
    w = max(_text_width(lab, size) for lab, _ in entries) + handle + 3 * size * 0.5
    h = row * len(entries) + size * 0.6
    x0, y0, x1, y1 = box
    inset = 0.5 * size
    corners = [(x1 - inset - w, y0 + inset), (x0 + inset, y0 + inset), (x1 - inset - w, y1 - inset - h),
               (x0 + inset, y1 - inset - h)]
    # the corner over the fewest data points (upper right first on a tie)
    pts_x, pts_y = [], []
    for p in ax.primitives:
        if p["kind"] in ("line", "step") and p["coords"] == "data":
            pts_x.append(mx(p["x"]))
            pts_y.append(my(p["y"]))
    px = np.concatenate(pts_x) if pts_x else np.zeros(0)
    py = np.concatenate(pts_y) if pts_y else np.zeros(0)
    counts = [int(((px >= cx) & (px <= cx + w) & (py >= cy) & (py <= cy + h)).sum()) for cx, cy in corners]
    lx, ly = corners[int(np.argmin(counts))]
    canvas.rect(lx, ly, lx + w, ly + h, "w", 0.8)
    edge = 0.8 * pt
    for a, b, c, d in ((lx, ly, lx + w, ly + edge), (lx, ly + h - edge, lx + w, ly + h), (lx, ly, lx + edge, ly + h),
                       (lx + w - edge, ly, lx + w, ly + h)):
        canvas.rect(a, b, c, d, (0.8, 0.8, 0.8))
    for i, (lab, p) in enumerate(entries):
        cy = ly + size * 0.3 + row * (i + 0.5)
        hx0 = lx + size * 0.5
        lw = max(p["lw"] * pt, 1.0)
        pattern = DASHES[p["ls"]]
        dashes = None if pattern is None else [d * lw for d in pattern]
        canvas.polyline([hx0, hx0 + handle], [cy, cy], lw, p["color"], p["alpha"], dashes)
        canvas.text(hx0 + handle + size * 0.5, cy, lab, size, ha="left", va="center")
