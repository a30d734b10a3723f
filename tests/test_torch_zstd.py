"""The port's zstd frame decoder (``alphadia_torch/csrc/zstd.cpp`` through
``rawdata/zstd.py``) against python-zstandard, on the CPU.

The corpus: the frame payloads of a synthetic 4D world, random and highly
repetitive bytes (hypothesis draws some), levels -5 to 22, frames with and
without ``Frame_Content_Size`` and checksum, multi-block, concatenated and
skippable frames, a long-distance-matching frame, and the batch call on 1
and several threads. Every decoded byte must equal zstandard's. Truncated,
bit-flipped and wrong-magic inputs must raise ``ZstdError`` and never bring
the process down. The decoder is built with this machine's ``g++``.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from alphadia_torch.rawdata import zstd
from alphadia_torch.testing.tdf_writer import xxh64 as writer_xxh64
from alphadia_torch.testing.tdf_writer import zstd_frame
from torch_tdf_fixture import DATA, frame_payloads

pytest_plugins = ("torch_port_plugin",)

LEVELS = (-5, 1, 3, 9, 19, 22)


def _compress(data: bytes, level=3, checksum=False, content_size=True) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum, write_content_size=content_size).compress(data)


@pytest.fixture(scope="module")
def world_payloads(tmp_path_factory):
    """The decoded frame payloads of a small 4D world written as a ``.d``."""
    from alphadia_torch.testing.synthetic import SyntheticConfig, make_synthetic_dia
    from alphadia_tpu.testing.tdf_writer import spectrum_data_to_tdf

    spectra, _, _ = make_synthetic_dia(SyntheticConfig(n_peptides=150, n_windows=3, n_cycles=40, with_mobility=True, seed=3))
    d_path = spectrum_data_to_tdf(spectra, tmp_path_factory.mktemp("zstd_world") / "run.d")
    return frame_payloads(d_path)


def _corpus() -> dict:
    rng = np.random.default_rng(11)
    text = Path(zstd.SOURCE).read_bytes()
    words = [bytes(rng.integers(97, 123, int(rng.integers(2, 9))).astype(np.uint8)) for _ in range(40)]
    return {
        "empty": b"",
        "one_byte": b"x",
        "zeros_300k": bytes(300_000),
        "random_200k": rng.bytes(200_000),
        "period_8": b"abcdefgh" * 40_000,
        "source_text_x8": text * 8,
        "small_alphabet": rng.integers(0, 4, 400_000).astype(np.uint8).tobytes(),
        "sorted_u32": np.sort(rng.integers(0, 5000, 100_000)).astype(np.uint32).tobytes(),
        "words": b" ".join(words[i] for i in rng.integers(0, 40, 60_000)),
        "runs": b"".join(bytes([int(b)]) * int(n) for b, n in zip(rng.integers(0, 256, 3000), rng.integers(1, 200, 3000))),
    }


CORPUS = _corpus()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(CORPUS))
def test_corpus_matches_zstandard(name, level):
    data = CORPUS[name]
    for checksum in (False, True):
        for content_size in (False, True):
            frame = _compress(data, level, checksum, content_size)
            assert zstd.decompress(frame) == data
            assert zstd.decompress(frame, len(data)) == data


@pytest.mark.parametrize("level", LEVELS)
def test_world_frame_payloads(world_payloads, level):
    """Every frame payload of the world, compressed at ``level``, in one
    batch call on 1 and 4 threads and one call at a time."""
    frames = [_compress(p, level, checksum=bool(i % 2), content_size=bool(i % 3)) for i, p in enumerate(world_payloads)]
    buf = b"".join(frames)
    offsets = np.cumsum([0] + [len(f) for f in frames[:-1]])
    sizes = [len(p) for p in world_payloads]
    want = b"".join(world_payloads)
    for threads in (1, 4):
        out = zstd.decompress_frames(buf, offsets, [len(f) for f in frames], sizes, threads)
        assert out.dtype == np.uint8 and out.tobytes() == want
    for f, p in zip(frames[:40], world_payloads):
        assert zstd.decompress(f) == p


@settings(max_examples=60, deadline=None)
@given(
    data=st.one_of(
        st.binary(max_size=5000),
        st.lists(st.sampled_from([b"\x00", b"ab", b"xyz!", b"\xff" * 7]), max_size=3000).map(b"".join),
    ),
    level=st.sampled_from(LEVELS),
    checksum=st.booleans(),
    content_size=st.booleans(),
)
def test_hypothesis_payloads(data, level, checksum, content_size):
    assert zstd.decompress(_compress(data, level, checksum, content_size)) == data


def test_multi_block_frame_and_window_descriptor():
    """A frame of several 128-KiB blocks, streamed (no content size, a
    window descriptor), and a single-segment one."""
    data = np.random.default_rng(5).integers(0, 16, 1_000_000).astype(np.uint8).tobytes()
    streamed = zstandard.ZstdCompressor(level=3).compressobj()
    frame = streamed.compress(data) + streamed.flush()
    assert zstd.decompress(frame) == data
    assert zstd.decompress(_compress(data, 19, checksum=True)) == data


def test_concatenated_and_skippable_frames():
    rng = np.random.default_rng(8)
    parts = [rng.bytes(1000), b"q" * 70_000, CORPUS["words"][:50_000]]
    skip = (0x184D2A53).to_bytes(4, "little") + (9).to_bytes(4, "little") + b"123456789"
    blob = _compress(parts[0], 1) + skip + _compress(parts[1], 9, checksum=True) + _compress(parts[2], 19, content_size=False)
    assert zstd.decompress(blob) == b"".join(parts)
    assert zstd.decompress(blob, sum(map(len, parts))) == b"".join(parts)
    assert zstd.decompress(skip) == b""


def test_long_distance_matching_frame():
    rng = np.random.default_rng(9)
    block = rng.bytes(2_000_000)
    data = block + rng.bytes(1000) + block[300_000:1_800_000]
    params = zstandard.ZstdCompressionParameters.from_level(19, enable_ldm=True, window_log=24)
    frame = zstandard.ZstdCompressor(compression_params=params).compress(data)
    assert len(frame) < len(data) * 0.7
    assert zstd.decompress(frame) == data


def test_batch_is_byte_identical_whatever_the_threads():
    rng = np.random.default_rng(2)
    payloads = [rng.integers(0, int(rng.integers(2, 200)), int(rng.integers(0, 50_000))).astype(np.uint8).tobytes()
                for _ in range(200)]
    frames = [_compress(p, int(rng.choice(LEVELS))) for p in payloads]
    buf = np.frombuffer(b"".join(frames), np.uint8)
    offsets = np.cumsum([0] + [len(f) for f in frames[:-1]])
    outs = [zstd.decompress_frames(buf, offsets, [len(f) for f in frames], [len(p) for p in payloads], t).tobytes()
            for t in (1, 2, 3, 8, 64)]
    assert all(o == b"".join(payloads) for o in outs)
    assert zstd.decompress_frames(buf, [], [], [], 4).size == 0


def test_the_writers_frames_and_checksums():
    """The port's TDF writer's raw/RLE frames read by both decoders, with
    and without the checksum, which both check; a wrong checksum raises."""
    rng = np.random.default_rng(4)
    for data in (b"", b"z", rng.bytes(300), bytes(200_000), rng.bytes(300_000) + bytes(140_000), b"ab" * 70_000):
        for checksum in (False, True):
            frame = zstd_frame(data, checksum)
            assert zstd.decompress(frame) == data
            assert zstandard.ZstdDecompressor().decompress(frame) == data
        bad = zstd_frame(data, True)[:-4] + ((writer_xxh64(data) + 1) & 0xFFFFFFFF).to_bytes(4, "little")
        with pytest.raises(zstd.ZstdError, match="checksum"):
            zstd.decompress(bad)


def test_committed_blob_against_its_record():
    """The fixture's frames (levels -5, 1, 19, checksums, content sizes, a
    multi-block frame) decode to the payloads whose sha256 it records."""
    rec = json.loads((DATA / "tdf_fixture.json").read_text())["frames"]
    buf = np.fromfile(DATA / "zstd_frames.bin", np.uint8)
    out = zstd.decompress_frames(buf, rec["offset"], rec["length"], rec["size"], 4)
    ends = np.cumsum(rec["size"])
    got = [hashlib.sha256(out[e - s : e].tobytes()).hexdigest() for e, s in zip(ends, rec["size"])]
    assert got == rec["sha256"]
    assert max(rec["size"]) > 128 * 1024 and {-5, 1, 19} <= set(rec["level"])
    assert set(rec["checksum"]) == {True, False} and set(rec["content_size"]) == {True, False}


# ---------------------------------------------------------------------------
# malformed input
# ---------------------------------------------------------------------------
MALFORMED_SOURCES = {
    "random": np.random.default_rng(21).bytes(3000),
    "text": Path(zstd.SOURCE).read_bytes()[:20_000],
    "sorted_u32": CORPUS["sorted_u32"][:40_000],
}


@pytest.mark.parametrize("level", (-5, 3, 19))
@pytest.mark.parametrize("name", sorted(MALFORMED_SOURCES))
def test_truncated_frames_raise(name, level):
    data = MALFORMED_SOURCES[name]
    frame = _compress(data, level, checksum=True)
    for cut in range(len(frame)):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:cut])
        if cut % 7 == 0:
            with pytest.raises(zstd.ZstdError):
                zstd.decompress(frame[:cut], len(data))


@pytest.mark.parametrize("level", (-5, 3, 19))
@pytest.mark.parametrize("name", sorted(MALFORMED_SOURCES))
def test_bit_flips_raise_or_change_nothing(name, level):
    """With a checksum, a flipped bit either raises or (in a bit the format
    ignores, such as the padding of a table description) decodes to the same
    bytes: never other bytes, never a crash."""
    data = MALFORMED_SOURCES[name]
    frame = _compress(data, level, checksum=True)
    rng = np.random.default_rng(level + 100)
    raised = 0
    for bit in rng.choice(len(frame) * 8, size=min(len(frame) * 8, 1500), replace=False):
        b = bytearray(frame)
        b[bit // 8] ^= 1 << (bit % 8)
        try:
            got = zstd.decompress(bytes(b))
        except zstd.ZstdError:
            raised += 1
            continue
        assert got == data, f"bit {bit}"
    assert raised > 0.9 * min(len(frame) * 8, 1500)


def test_wrong_magic_garbage_and_wrong_sizes_raise():
    frame = _compress(b"hello world" * 100, 3)
    for bad in (b"\x00" + frame[1:], b"\x28\xb5\x2f", frame + b"\x01\x02", frame + frame[:4]):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bad)
    with pytest.raises(zstd.ZstdError, match="expected|larger"):
        zstd.decompress(frame, 1099)
    with pytest.raises(zstd.ZstdError, match="expected|larger"):
        zstd.decompress(frame, 1101)
    rng = np.random.default_rng(1)
    magic = (0xFD2FB528).to_bytes(4, "little")
    for _ in range(3000):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(magic + rng.bytes(int(rng.integers(0, 120))))


def test_dictionary_frames_are_refused():
    d = zstandard.train_dictionary(2048, [bytes(np.random.default_rng(i).integers(97, 100, 300).astype(np.uint8)) for i in range(200)])
    frame = zstandard.ZstdCompressor(dict_data=d).compress(b"abcabcabc" * 20)
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(frame)


def test_batch_names_the_first_bad_input():
    good = _compress(b"a" * 1000, 3)
    buf = good + b"\x00" * len(good) + good
    with pytest.raises(zstd.ZstdError) as e:
        zstd.decompress_frames(buf, [0, len(good), 2 * len(good)], [len(good)] * 3, [1000] * 3, 3)
    assert e.value.index == 1
    with pytest.raises(ValueError, match="outside"):
        zstd.decompress_frames(buf, [0], [len(buf) + 1], [1000], 1)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------
def test_builds_with_this_machines_compiler(tmp_path, monkeypatch):
    monkeypatch.setenv("ALPHADIA_TORCH_BUILD_DIR", str(tmp_path))
    lib = zstd.build()
    assert lib.parent == tmp_path and lib.name.startswith("libzstd_") and lib.suffix == ".so"
    assert zstd.build() == lib  # built once per source and flags
    assert not list(tmp_path.glob("*.tmp"))


def test_no_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("ALPHADIA_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(zstd.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        zstd.build()
