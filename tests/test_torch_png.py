"""The port's PNG writer and reader (``alphadia_torch/utils/png.py``)
against PIL and matplotlib, which the card machine lacks:

- PIL reads what ``write_png`` writes as the same pixels, RGBA 8-bit;
- ``read_png`` reads the files PIL writes (colour types 2 and 6, with
  PIL's filters) and matplotlib's ``savefig`` and ``imsave`` as PIL reads
  them;
- a corrupt or unsupported file raises.
"""

import io
import struct
import zlib

import matplotlib
import numpy as np
import pytest
from PIL import Image

from alphadia_torch.utils.png import decode_png, encode_png, read_png, write_png

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

pytest_plugins = ("torch_port_plugin",)


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[: h // 3] = 255  # runs of one colour, as a figure has
    img[h // 2, :, :3] = 0
    return img


@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (37, 53), (120, 257)])
def test_pil_reads_what_the_port_writes(tmp_path, shape):
    img = _image(*shape, seed=shape[0])
    path = write_png(tmp_path / "a.png", img)
    with Image.open(path) as im:
        assert im.mode == "RGBA" and im.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_the_port_reads_what_pil_writes(tmp_path, mode):
    src = Image.fromarray(_image(61, 77, seed=3)).convert(mode)
    for optimize in (False, True):
        path = tmp_path / f"{mode}_{optimize}.png"
        src.save(path, optimize=optimize)
        with Image.open(path) as im:
            ref = np.asarray(im)
        got = read_png(path)
        np.testing.assert_array_equal(got.reshape(ref.shape), ref)


def test_the_port_reads_what_matplotlib_writes(tmp_path):
    fig, ax = plt.subplots(figsize=(9, 3.5))
    ax.plot(np.random.default_rng(0).random(200))
    ax.set_title("proba")
    fig.savefig(tmp_path / "fig.png", dpi=120)
    plt.close(fig)
    plt.imsave(tmp_path / "imsave.png", np.random.default_rng(1).random((30, 40)))
    for name in ("fig.png", "imsave.png"):
        with Image.open(tmp_path / name) as im:
            ref = np.asarray(im)
        got = read_png(tmp_path / name)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    assert read_png(tmp_path / "fig.png").shape == (420, 1080, 4)


def test_bad_files_raise():
    data = encode_png(_image(5, 6, seed=0))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + data[6:])
    broken = bytearray(data)
    broken[40] ^= 0xFF  # inside IDAT: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(broken))
    with pytest.raises(ValueError, match="truncated"):
        decode_png(data[:-20])
    # a 16-bit file is outside the subset
    header = struct.pack(">IIBBBBB", 1, 1, 16, 6, 0, 0, 0)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    sixteen = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(bytes(9))) + chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(sixteen)
    grey = io.BytesIO()
    Image.fromarray(_image(4, 4, seed=1)).convert("L").save(grey, format="png")
    with pytest.raises(ValueError, match="colour type 0"):
        decode_png(grey.getvalue())
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((2, 2, 3), np.uint8))


def test_pil_reads_the_bytes_of_encode_png():
    img = _image(19, 23, seed=7)
    with Image.open(io.BytesIO(encode_png(img, level=9))) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
