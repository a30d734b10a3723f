"""Makes the committed font of the port's figure layer,
``alphadia_torch/reporting/font/``: what a machine without a font
rasteriser (the card's: no PIL, no matplotlib) cannot make itself.

- ``dejavu_sans.npz``: the printable ASCII characters (32-126) of DejaVu
  Sans, the font matplotlib draws its text in, rasterised by PIL from the
  TrueType file that matplotlib ships, at ``EM`` pixels an em. ``alpha``
  holds every glyph's cell side by side (uint8 coverage, one row per pixel
  from the ascent line to the descent line), ``left`` the first column of
  each cell, ``width`` its columns, ``advance`` the pen's advance in pixels
  (float), ``ascent`` and ``descent`` the rows above and below the
  baseline, ``em`` the size;
- ``LICENSE_DEJAVU``: the font's licence, copied from matplotlib.

    PYTHONPATH=. python tests/torch_font_atlas.py
"""

from __future__ import annotations

import shutil
from pathlib import Path

import matplotlib
import numpy as np
from PIL import Image, ImageDraw, ImageFont

EM = 40
PAD = 2  # columns each side of a glyph's advance, for overhanging strokes
OUT = Path(__file__).resolve().parents[1] / "alphadia_torch" / "reporting" / "font"


def main() -> None:
    ttf = Path(matplotlib.get_data_path()) / "fonts" / "ttf"
    font = ImageFont.truetype(str(ttf / "DejaVuSans.ttf"), EM)
    ascent, descent = font.getmetrics()
    cells, advance = [], []
    for code in range(32, 127):
        ch = chr(code)
        adv = font.getlength(ch)
        width = int(np.ceil(adv)) + 2 * PAD
        img = Image.new("L", (width, ascent + descent), 0)
        ImageDraw.Draw(img).text((PAD, ascent), ch, font=font, fill=255, anchor="ls")
        cells.append(np.asarray(img, np.uint8))
        advance.append(adv)
    widths = np.array([c.shape[1] for c in cells], np.int32)
    OUT.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        OUT / "dejavu_sans.npz",
        alpha=np.concatenate(cells, axis=1),
        left=np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int32),
        width=widths,
        advance=np.array(advance, np.float32),
        ascent=np.int32(ascent),
        descent=np.int32(descent),
        em=np.int32(EM),
        pad=np.int32(PAD),
    )
    shutil.copy(ttf / "LICENSE_DEJAVU", OUT / "LICENSE_DEJAVU")
    print(f"wrote {OUT / 'dejavu_sans.npz'} ({(OUT / 'dejavu_sans.npz').stat().st_size} bytes)")


if __name__ == "__main__":
    main()
