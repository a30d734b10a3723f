"""Makes the committed TDF fixture of the port's zstd decoder and Bruker
reader, ``alphadia_torch/testing/data/``: what a machine without a zstd
compressor (the card's) cannot make itself.

- ``tdf_world.d``: a small 4D world of the port's generator, made from
  sequences (200 peptides, 3 windows, 100 cycles, 80 noise peaks a
  spectrum, seed 5, with mobility) so that a TSV library of its targets
  builds, written by the JAX package's TDF writer, whose frames
  python-zstandard compresses at its default level 3;
- ``zstd_frames.bin``: the decoded payloads of those frames compressed
  again, frame by frame, with python-zstandard at levels -5, 1 and 19, with
  and without the checksum and ``Frame_Content_Size`` (the variants taken in
  turn), and one more frame of the first payloads one after another (over
  128 KiB, so several blocks);
- ``tdf_fixture.json``: per frame of the blob (a list per key) its offset,
  length and decoded size, how it was compressed, the sha256 of each decoded payload, and the
  sha256 of every array the JAX package's ``read_bruker_d`` gives for
  ``tdf_world.d``.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_tdf_fixture.py
"""

from __future__ import annotations

import hashlib
import json
import shutil
import sqlite3
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parents[1] / "alphadia_torch" / "testing" / "data"
WORLD = dict(
    n_peptides=200, n_windows=3, n_cycles=100, noise_peaks_per_spectrum=80, seed=5, with_mobility=True, from_sequence=True,
)
VARIANTS = [  # (level, checksum, content size)
    (-5, True, True), (1, False, True), (19, True, False), (1, True, False), (-5, False, False), (19, False, True),
]
BIG_FRAME_BYTES = 160 * 1024
FIELDS = ("rt", "ms_level", "isolation_lower_mz", "isolation_upper_mz", "peak_start_idx", "peak_stop_idx", "mz",
          "intensity", "mobility")


def array_sha256(spectra) -> dict:
    """sha256 of each array of a ``SpectrumData`` (dtype and bytes)."""
    out = {}
    for f in FIELDS:
        a = np.ascontiguousarray(getattr(spectra, f))
        out[f] = hashlib.sha256(a.dtype.str.encode() + a.tobytes()).hexdigest()
    return out


def frame_payloads(d_path: Path) -> list[bytes]:
    """The decoded payload of every frame of a ``.d`` (python-zstandard)."""
    import zstandard

    con = sqlite3.connect(d_path / "analysis.tdf")
    offsets = [r[0] for r in con.execute("SELECT TimsId FROM Frames ORDER BY Id")]
    con.close()
    buf = (d_path / "analysis.tdf_bin").read_bytes()
    dctx = zstandard.ZstdDecompressor()
    out = []
    for off in offsets:
        n = int.from_bytes(buf[off : off + 4], "little")
        out.append(dctx.decompress(buf[off + 8 : off + n], max_output_size=1 << 26))
    return out


def main():
    import zstandard

    from alphadia_torch.testing.synthetic import SyntheticConfig, make_synthetic_dia
    from alphadia_tpu.rawdata.bruker_tdf import read_bruker_d
    from alphadia_tpu.testing.tdf_writer import spectrum_data_to_tdf

    spectra, _, _ = make_synthetic_dia(SyntheticConfig(**WORLD))
    d_path = DATA / "tdf_world.d"
    if d_path.exists():
        shutil.rmtree(d_path)
    spectrum_data_to_tdf(spectra, d_path)
    payloads = frame_payloads(d_path)
    big = b""
    for p in payloads:
        if len(big) >= BIG_FRAME_BYTES:
            break
        big += p
    payloads.append(big)
    blob, frames = bytearray(), {}
    for i, p in enumerate(payloads):
        level, checksum, size = VARIANTS[i % len(VARIANTS)] if i < len(payloads) - 1 else (19, True, False)
        c = zstandard.ZstdCompressor(level=level, write_checksum=checksum, write_content_size=size).compress(p)
        for k, v in (("offset", len(blob)), ("length", len(c)), ("size", len(p)), ("level", level),
                     ("checksum", checksum), ("content_size", size), ("sha256", hashlib.sha256(p).hexdigest())):
            frames.setdefault(k, []).append(v)
        blob += c
    (DATA / "zstd_frames.bin").write_bytes(bytes(blob))
    record = {
        "world": WORLD,
        "zstandard": zstandard.__version__,
        "read_bruker_d_sha256": array_sha256(read_bruker_d(d_path)),
        "n_peaks": int(len(spectra.mz)),
        "frames": frames,
    }
    (DATA / "tdf_fixture.json").write_text(json.dumps(record) + "\n")
    total = sum(p.stat().st_size for p in DATA.rglob("*") if p.is_file())
    print(f"{len(frames['size'])} frames, {record['n_peaks']} peaks, {len(blob)} B of blob, {total} B in {DATA}")


if __name__ == "__main__":
    main()
