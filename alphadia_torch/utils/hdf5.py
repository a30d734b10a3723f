"""A reader and a writer of the HDF5 files h5py writes.

The card machine has no h5py, so the port reads and writes the HDF files
of the JAX package (spectra caches, libraries) and alphaRaw's raw files
itself, in numpy, ``zlib`` and ``struct``. The reader takes what
``h5py.File(path, "w")`` writes at its defaults (``libver="earliest"``),
with ``libver="latest"`` (or ``("v108", "latest")``) and with
``track_order=True``:

- superblock versions 0 and 1 (a user block before it is found too) and 2
  and 3 (checksummed); object headers of version 1 (continuation blocks)
  and version 2 (``OHDR``/``OCHK``, the optional times, attribute phase
  change and chunk-size width, Jenkins lookup3 checksums);
- groups as symbol tables (a version-1 B-tree of group nodes, a local
  heap, ``SNOD`` nodes) or new-style (link info and hard-link messages:
  compact, or dense in a fractal heap of direct and indirect blocks indexed
  by a version-2 B-tree of leaf and internal nodes, the creation-order
  index too where the group tracks it, checked against the name index);
- messages: dataspace (scalar and simple, versions 1 and 2), datatype,
  fill value (versions 1-3), attribute (versions 1-3; dense attribute
  storage through the attribute info message), filter pipeline (versions 1
  and 2), data layout version 3 (compact, contiguous, chunked with the
  version-1 B-tree chunk index: any depth, partial edge chunks stored at
  full chunk size) and version 4 (its chunk indexes: single chunk,
  implicit, fixed array with data-block pages, extensible array with its
  index, super and data blocks and pages, version-2 B-tree);
- datatypes: little-endian fixed-point of 8-64 bits, IEEE float16/32/64,
  fixed-length strings (``S``, trailing NULs stripped as numpy strips
  them), variable-length strings (the global heap; read as ``str``) and
  enums (an 8-bit FALSE/TRUE enum, h5py's ``bool``, reads as ``bool``;
  other enums as their base integers);
- filters: deflate (1), shuffle (2), fletcher32 (3, verified) and LZF
  (32000, h5py's own), honouring a chunk's filter mask.

Anything else raises ``ValueError`` naming the structure: soft and
external links, shared messages, huge fractal-heap objects, big-endian or
non-IEEE types, compound and other classes, variable-length sequences,
other layouts and filters. So do truncated and corrupted files and
checksum mismatches.

    with File(path) as f:                     # reading: h5py's small API
        f.attrs.get("format"); "peak_df" in f; f["peak_df"]["mz"][:]

    root = Group(attrs={"format": "..."})      # writing
    root.create_group("precursor_df").create_dataset("mz", data=array)
    write(path, root, threads=4)

The writer writes the version-0 subset of h5py's defaults and nothing that depends on
the clock: every array as a chunked dataset under deflate level 1 with
h5py's chunk shape (``guess_chunk``), scalars as contiguous ones; ``str``
attributes and object/unicode arrays as variable-length UTF-8 strings,
``bool`` as h5py's enum. Chunks are (de)compressed on ``threads`` threads
(``zlib`` releases the GIL); the bytes do not depend on their count.
"""

from __future__ import annotations

import math
import mmap
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _EXTERNAL, _LAYOUT, _PIPELINE, _ATTRIBUTE = 0x6, 0x7, 0x8, 0xB, 0xC
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15
_SHARED_TABLE = 0x0F
_REFUSED_MESSAGES = {
    _EXTERNAL: "external data files message",
    _SHARED_TABLE: "shared object header message table",
}
# version-2 B-tree record types read: group links by name and creation
# order, attributes by name, chunks (not filtered, filtered)
_BT2_LINK_NAME, _BT2_LINK_ORDER, _BT2_ATTR_NAME, _BT2_CHUNK, _BT2_CHUNK_FILTERED = 5, 6, 8, 10, 11
_CLASS_NAMES = {
    0: "fixed-point", 1: "floating-point", 2: "time", 3: "string", 4: "bitfield", 5: "opaque",
    6: "compound", 7: "reference", 8: "enumerated", 9: "variable-length", 10: "array",
}
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf"}
_IEEE = {  # size: (bit offset, precision, exponent location, size, mantissa location, size, bias, sign location)
    2: (0, 16, 10, 5, 0, 10, 15, 15),
    4: (0, 32, 23, 8, 0, 23, 127, 31),
    8: (0, 64, 52, 11, 0, 52, 1023, 63),
}
# the deflate filter's largest ratio, which bounds what a chunked dataset
# can expand to: a larger shape is taken as corruption
_MAX_EXPANSION = 1032


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------
class _Source:
    """The file's bytes with bounds-checked access; addresses relative to
    the superblock's base address."""

    def __init__(self, buf, name: str):
        self.buf, self.name, self.base = buf, name, 0
        self.size = len(buf)
        self.o = self.l = 8

    def read(self, addr: int, n: int) -> bytes:
        a = self.base + addr
        if addr < 0 or n < 0 or a + n > self.size:
            raise ValueError(f"{self.name}: truncated or corrupt: {n} bytes at address {addr} past the file's end")
        return self.buf[a : a + n]

    def view(self, addr: int, n: int) -> memoryview:
        a = self.base + addr
        if addr < 0 or n < 0 or a + n > self.size:
            raise ValueError(f"{self.name}: truncated or corrupt: {n} bytes at address {addr} past the file's end")
        return memoryview(self.buf)[a : a + n]

    def undef(self, addr: int) -> bool:
        return addr == (1 << (8 * self.o)) - 1


def _uint(b, p: int, n: int) -> int:
    if p + n > len(b):
        raise ValueError("truncated structure")
    return int.from_bytes(b[p : p + n], "little")


# lookup3's mix and final rounds as (i, j, k, rotation) on v = [a, b, c]:
# mix: v[i] -= v[j]; v[i] ^= rot(v[j], r); v[j] += v[k]; final: v[i] ^= v[j];
# v[i] -= rot(v[j], r)
_MIX = ((0, 2, 1, 4), (1, 0, 2, 6), (2, 1, 0, 8), (0, 2, 1, 16), (1, 0, 2, 19), (2, 1, 0, 4))
_FINAL = ((2, 1, 14), (0, 2, 11), (1, 0, 25), (2, 1, 16), (0, 2, 4), (1, 0, 14), (2, 1, 24))


def lookup3(data) -> int:
    """Bob Jenkins' lookup3 ``hashlittle`` with initial value 0, HDF5's
    metadata checksum."""
    data = bytes(data)
    n, m = len(data), 0xFFFFFFFF
    v = [(0xDEADBEEF + n) & m] * 3

    def rot(x, k):
        return ((x << k) | (x >> (32 - k))) & m

    full = (n - 1) // 12 if n else 0
    words = struct.unpack_from(f"<{3 * full}I", data) if full else ()
    for w in range(full):
        v = [(v[q] + words[3 * w + q]) & m for q in range(3)]
        for i, j, k, r in _MIX:
            v[i] = ((v[i] - v[j]) & m) ^ rot(v[j], r)
            v[j] = (v[j] + v[k]) & m
    if n == 0:
        return v[2]
    tail = struct.unpack("<3I", data[12 * full :] + bytes(12 - (n - 12 * full)))
    v = [(v[q] + tail[q]) & m for q in range(3)]
    for i, j, r in _FINAL:
        v[i] = ((v[i] ^ v[j]) - rot(v[j], r)) & m
    return v[2]


def _checked(block, what: str, src, addr: int) -> None:
    """``block``'s last 4 bytes are the lookup3 of the bytes before them."""
    if len(block) < 4 or _uint(block, len(block) - 4, 4) != lookup3(block[:-4]):
        raise ValueError(f"{src.name}: checksum mismatch in the {what} at address {addr}")


def _enc_size(n: int) -> int:
    """Bytes HDF5 takes to encode counts up to ``n`` (``H5VM_limit_enc_size``)."""
    return max(int(n).bit_length() - 1, 0) // 8 + 1


class _Type:
    """A datatype: ``kind`` is ``num`` (a numpy dtype as stored), ``bool``
    (the 8-bit FALSE/TRUE enum), ``vstr`` (variable-length string)."""

    def __init__(self, kind: str, dtype: np.dtype, size: int):
        self.kind, self.dtype, self.size = kind, dtype, size

    @property
    def storage(self) -> np.dtype:
        return np.dtype(f"V{self.size}") if self.kind == "vstr" else self.dtype


def _parse_datatype(b, p: int, src: _Source) -> tuple[_Type, int]:
    if p + 8 > len(b):
        raise ValueError("truncated datatype message")
    cls, version = b[p] & 0x0F, b[p] >> 4
    bits = b[p + 1] | (b[p + 2] << 8) | (b[p + 3] << 16)
    size = _uint(b, p + 4, 4)
    p += 8
    if version not in (1, 2, 3, 4):  # 4: libver "latest" (v114) encodes as 3 does
        raise ValueError(f"datatype message version {version}")
    if cls == 0:
        offset, precision = struct.unpack_from("<HH", b, p)
        if bits & 1:
            raise ValueError("big-endian fixed-point datatype")
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            raise ValueError(f"fixed-point datatype of {size} bytes with {precision} bits at bit {offset}")
        return _Type("num", np.dtype(f"<{'i' if bits & 8 else 'u'}{size}"), size), p + 4
    if cls == 1:
        if bits & 1 or bits & 0x40:
            raise ValueError("big-endian (or VAX-order) floating-point datatype")
        fields = struct.unpack_from("<HHBBBBI", b, p) + ((bits >> 8) & 0xFF,)
        if _IEEE.get(size) != fields or (bits >> 4) & 3 != 2:
            raise ValueError(f"non-IEEE floating-point datatype of {size} bytes")
        return _Type("num", np.dtype(f"<f{size}"), size), p + 12
    if cls == 3:
        if size == 0:
            raise ValueError("fixed-length string datatype of 0 bytes")
        return _Type("num", np.dtype(f"S{size}"), size), p
    if cls == 8:
        n = bits & 0xFFFF
        base, p = _parse_datatype(b, p, src)
        if base.kind != "num" or base.dtype.kind not in "iu" or base.size != size:
            raise ValueError("enumerated datatype over a base that is not an integer of its size")
        names = []
        for _ in range(n):
            end = bytes(b[p:]).find(b"\0")
            if end < 0:
                raise ValueError("truncated enumerated datatype")
            names.append(bytes(b[p : p + end]))
            p += end + 1 if version >= 3 else (end + 8) // 8 * 8
        values = np.frombuffer(bytes(b[p : p + n * size]), dtype=base.dtype)
        if len(values) != n:
            raise ValueError("truncated enumerated datatype")
        p += n * size
        if size == 1 and sorted(zip(names, values.tolist())) == [(b"FALSE", 0), (b"TRUE", 1)]:
            return _Type("bool", np.dtype(bool), 1), p
        return base, p
    if cls == 9:
        if bits & 0xF != 1:
            raise ValueError("variable-length sequence datatype (only variable-length strings are read)")
        base, p = _parse_datatype(b, p, src)
        if size != 8 + src.o:
            raise ValueError(f"variable-length string datatype of {size} bytes")
        return _Type("vstr", np.dtype(object), size), p
    raise ValueError(f"{_CLASS_NAMES.get(cls, f'class-{cls}')} datatype")


def _parse_dataspace(b, src: _Source, maxshape: bool = False) -> tuple | None:
    """The shape (with ``maxshape``: the largest shape, the shape itself
    where the message holds none; ``-1`` for an unlimited dimension);
    ``None`` for a null dataspace."""
    if len(b) < 4 or (b[0] == 1 and len(b) < 8):
        raise ValueError("truncated dataspace message")
    version, rank, flags = b[0], b[1], b[2]
    if version == 1:
        p, kind = 8, 1 if rank else 0
    elif version == 2:
        p, kind = 4, b[3]
    else:
        raise ValueError(f"dataspace message version {version}")
    if kind == 2:
        return None
    if kind == 0:
        return ()
    dims = tuple(_uint(b, p + i * src.l, src.l) for i in range(rank))
    if not maxshape or not flags & 1:
        return dims
    unlimited = (1 << (8 * src.l)) - 1
    return tuple(-1 if m == unlimited else m for m in (_uint(b, p + (rank + i) * src.l, src.l) for i in range(rank)))


class _Heap:
    """A global heap collection: object index -> bytes."""

    def __init__(self, src: _Source, addr: int):
        head = src.read(addr, 8 + src.l)
        if head[:4] != b"GCOL":
            raise ValueError(f"{src.name}: no global heap collection at address {addr}")
        size = _uint(head, 8, src.l)
        body = src.read(addr, size)
        self.objects: dict[int, bytes] = {}
        p = 8 + src.l
        while p + 8 + src.l <= size:
            index = _uint(body, p, 2)
            if index == 0:
                break
            n = _uint(body, p + 8, src.l)
            start = p + 8 + src.l
            if start + n > size:
                raise ValueError(f"{src.name}: global heap object {index} past its collection's end")
            self.objects[index] = bytes(body[start : start + n])
            p = start + (n + 7) // 8 * 8


class _FractalHeap:
    """A fractal heap's managed and tiny objects by heap ID: a root direct
    block, or a root indirect block of direct blocks and indirect blocks
    (the doubling table of ``H5HFdtable.c``)."""

    def __init__(self, src: _Source, addr: int):
        self.src, self.addr = src, addr
        o, l = src.o, src.l
        n = 22 + 12 * l + 3 * o
        head = src.read(addr, n + 4)
        if head[:4] != b"FRHP" or head[4] != 0:
            raise ValueError(f"{src.name}: no fractal heap header (FRHP) at address {addr}")
        self.id_len, filters, self.flags = _uint(head, 5, 2), _uint(head, 7, 2), head[9]
        if filters:
            raise ValueError(f"{src.name}: fractal heap with I/O filters at address {addr}")
        _checked(head, "fractal heap header", src, addr)
        max_managed = _uint(head, 10, 4)
        p = 14 + 10 * l + 2 * o
        self.width, self.start = _uint(head, p, 2), _uint(head, p + 2, l)
        self.max_direct, self.max_heap = _uint(head, p + 2 + l, l), _uint(head, p + 2 + 2 * l, 2)
        self.root, self.root_rows = _uint(head, p + 6 + 2 * l, o), _uint(head, p + 6 + 2 * l + o, 2)
        pow2 = lambda v: v > 0 and v & (v - 1) == 0  # noqa: E731
        if not (pow2(self.width) and pow2(self.start) and pow2(self.max_direct)) or not 0 < self.max_heap <= 64:
            raise ValueError(f"{src.name}: fractal heap of width {self.width}, blocks {self.start}-{self.max_direct}")
        self.off_size = (self.max_heap + 7) // 8
        self.len_size = min((self.max_direct.bit_length() - 1 + 7) // 8, _enc_size(max_managed))
        self.first_row_bits = (self.start.bit_length() - 1) + (self.width.bit_length() - 1)
        self.max_direct_rows = (self.max_direct.bit_length() - 1) - (self.start.bit_length() - 1) + 2
        self._blocks: dict[int, tuple] = {}

    def _row_size(self, row: int) -> int:
        return self.start if row == 0 else self.start << (row - 1)

    def _lookup(self, off: int) -> tuple[int, int]:
        """(row, column) of a heap offset in a block's doubling table."""
        if off < self.start * self.width:
            return 0, off // self.start
        high = off.bit_length() - 1
        row = high - self.first_row_bits + 1
        return row, (off - (1 << high)) // self._row_size(row)

    def _indirect(self, addr: int, rows: int) -> tuple[int, list[int]]:
        """An indirect block: (its heap offset, its entries' addresses)."""
        key = ("i", addr)
        if key not in self._blocks:
            src, o = self.src, self.src.o
            n = rows * self.width
            block = src.read(addr, 5 + o + self.off_size + n * o + 4)
            if block[:4] != b"FHIB" or block[4] != 0 or _uint(block, 5, o) != self.addr:
                raise ValueError(f"{src.name}: no fractal heap indirect block (FHIB) at address {addr}")
            _checked(block, "fractal heap indirect block", src, addr)
            p = 5 + o + self.off_size
            self._blocks[key] = (_uint(block, 5 + o, self.off_size), [_uint(block, p + i * o, o) for i in range(n)])
        return self._blocks[key]

    def _direct(self, addr: int, size: int) -> tuple[int, bytes]:
        """A direct block: (its heap offset, its bytes)."""
        key = ("d", addr)
        if key not in self._blocks:
            src, o = self.src, self.src.o
            block = src.read(addr, size)
            if block[:4] != b"FHDB" or block[4] != 0 or _uint(block, 5, o) != self.addr:
                raise ValueError(f"{src.name}: no fractal heap direct block (FHDB) at address {addr}")
            if self.flags & 0x02:
                at = 5 + o + self.off_size
                if _uint(block, at, 4) != lookup3(block[:at] + b"\0\0\0\0" + block[at + 4 :]):
                    raise ValueError(f"{src.name}: checksum mismatch in the fractal heap direct block at address {addr}")
            self._blocks[key] = (_uint(block, 5 + o, self.off_size), block)
        return self._blocks[key]

    def object(self, hid) -> bytes:
        src = self.src
        if len(hid) < 1 or hid[0] >> 6:
            raise ValueError(f"{src.name}: fractal heap ID of version {hid[0] >> 6 if len(hid) else '?'}")
        kind = (hid[0] >> 4) & 3
        if kind == 2:  # tiny: the object in the ID
            n, p = ((hid[0] & 0x0F) + 1, 1) if self.id_len <= 18 else ((((hid[0] & 0x0F) << 8) | hid[1]) + 1, 2)
            if p + n > len(hid):
                raise ValueError(f"{src.name}: tiny fractal heap object longer than its ID")
            return bytes(hid[p : p + n])
        if kind != 0:
            raise ValueError(f"{src.name}: huge fractal heap object (kind {kind}) in the heap at address {self.addr}")
        off = _uint(hid, 1, self.off_size)
        n = _uint(hid, 1 + self.off_size, self.len_size)
        if self.root_rows == 0:
            block_off, block = self._direct(self.root, self.start)
        else:
            addr, rows, depth = self.root, self.root_rows, 0
            block_off, entries = self._indirect(addr, rows)
            while True:
                row, col = self._lookup(off - block_off)
                if row >= rows or depth > 64:
                    raise ValueError(f"{src.name}: fractal heap offset {off} outside its heap")
                addr = entries[row * self.width + col]
                if src.undef(addr):
                    raise ValueError(f"{src.name}: fractal heap offset {off} in an unallocated block")
                if row < self.max_direct_rows:
                    block_off, block = self._direct(addr, self._row_size(row))
                    break
                rows = (self._row_size(row).bit_length() - 1) - self.first_row_bits + 1
                block_off, entries = self._indirect(addr, rows)
                depth += 1
        at = off - block_off
        if at < 0 or at + n > len(block):
            raise ValueError(f"{src.name}: fractal heap object of {n} bytes at offset {off} outside its block")
        return bytes(block[at : at + n])


class _Reader:
    def __init__(self, src: _Source, threads: int = 1):
        self.src, self.threads = src, threads
        self.heaps: dict[int, _Heap] = {}
        self.fheaps: dict[int, _FractalHeap] = {}
        self._pool: ThreadPoolExecutor | None = None

    def map(self, fn, items) -> None:
        """``fn`` on every item, on the file's threads (one pool for all its
        datasets)."""
        if self.threads > 1 and len(items) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self.threads)
            list(self._pool.map(fn, items))
        else:
            for item in items:
                fn(item)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def heap_object(self, addr: int, index: int) -> bytes:
        if addr not in self.heaps:
            self.heaps[addr] = _Heap(self.src, addr)
        try:
            return self.heaps[addr].objects[index]
        except KeyError:
            raise ValueError(f"{self.src.name}: global heap object {index} missing at address {addr}") from None

    def strings(self, raw: np.ndarray) -> np.ndarray:
        """Variable-length string records (length u32, collection address,
        object index u32) as an object array of ``str``."""
        o = self.src.o
        rec = np.frombuffer(raw.tobytes(), dtype=np.uint8).reshape(-1, 8 + o)
        out = np.empty(len(rec), dtype=object)
        for i, r in enumerate(rec):
            n = int.from_bytes(r[:4].tobytes(), "little")
            if n == 0:
                out[i] = ""
                continue
            addr, index = int.from_bytes(r[4 : 4 + o].tobytes(), "little"), int.from_bytes(r[4 + o :].tobytes(), "little")
            data = self.heap_object(addr, index)
            if n > len(data):
                raise ValueError(f"{self.src.name}: variable-length string of {n} bytes in a heap object of {len(data)}")
            out[i] = data[:n].decode("utf-8")
        return out.reshape(raw.shape)

    def messages(self, addr: int) -> list[tuple[int, int, bytes]]:
        """The messages of the object header at ``addr`` (version 1 or 2),
        its continuation blocks followed: [(type, flags, body)]."""
        src = self.src
        head = src.read(addr, 16)
        if head[:4] == b"OHDR":
            if head[4] != 2:
                raise ValueError(f"{src.name}: OHDR object header version {head[4]} at address {addr}")
            flags = head[5]
            p = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            size = _uint(src.read(addr + p, width), 0, width)
            body = addr + p + width
            _checked(src.read(addr, body - addr + size + 4), "object header", src, addr)
            blocks, prefix = [(body, size)], 6 if flags & 0x04 else 4
        elif head[0] == 1:
            blocks, prefix = [(addr + 16, _uint(head, 8, 4))], 8
        else:
            raise ValueError(f"{src.name}: object header version {head[0]} at address {addr}")
        seen, out = {addr}, []
        while blocks:
            start, size = blocks.pop(0)
            body = src.read(start, size)
            p = 0
            while p + prefix <= size:
                if prefix == 8:
                    mtype, msize, flags = struct.unpack_from("<HHB", body, p)
                else:
                    mtype, msize, flags = body[p], _uint(body, p + 1, 2), body[p + 3]
                if p + prefix + msize > size:
                    raise ValueError(f"{src.name}: object header message past its block at address {addr}")
                data = body[p + prefix : p + prefix + msize]
                p += prefix + msize
                if mtype == _CONTINUATION:
                    cont, n = _uint(data, 0, src.o), _uint(data, src.o, src.l)
                    if cont in seen:
                        raise ValueError(f"{src.name}: object header continuation loop at address {cont}")
                    seen.add(cont)
                    if prefix == 8:
                        blocks.append((cont, n))
                        continue
                    block = src.read(cont, n)
                    if block[:4] != b"OCHK":
                        raise ValueError(f"{src.name}: no object header continuation block (OCHK) at address {cont}")
                    _checked(block, "object header continuation block", src, cont)
                    blocks.append((cont + 4, n - 8))
                elif mtype in _REFUSED_MESSAGES:
                    raise ValueError(f"{src.name}: {_REFUSED_MESSAGES[mtype]} at address {addr}")
                elif flags & 0x02 and mtype != _NIL:
                    raise ValueError(f"{src.name}: shared object header message (type {mtype:#x}) at address {addr}")
                elif mtype != _NIL:
                    out.append((mtype, flags, data))
        return out

    def _attribute(self, b) -> tuple[str, object]:
        """One attribute message: (name, value)."""
        version = b[0]
        if version == 1:
            pad = lambda n: (n + 7) // 8 * 8  # noqa: E731
            p = 8
        elif version in (2, 3):
            if b[1] & 3:
                raise ValueError(f"{self.src.name}: attribute with a shared datatype or dataspace")
            pad = lambda n: n  # noqa: E731
            p = 9 if version == 3 else 8
        else:
            raise ValueError(f"{self.src.name}: attribute message version {version}")
        name_n, type_n, space_n = struct.unpack_from("<HHH", b, 2)
        name = bytes(b[p : p + name_n]).split(b"\0")[0].decode("utf-8")
        p += pad(name_n)
        dtype, _ = _parse_datatype(b[p : p + type_n], 0, self.src)
        p += pad(type_n)
        shape = _parse_dataspace(b[p : p + space_n], self.src)
        p += pad(space_n)
        if shape is None:
            return name, None
        count = math.prod(shape)
        raw = bytes(b[p : p + count * dtype.size])
        if len(raw) != count * dtype.size:
            raise ValueError(f"{self.src.name}: truncated attribute {name!r}")
        value = self.convert(np.frombuffer(raw, dtype=dtype.storage).reshape(shape), dtype)
        return name, value[()] if shape == () else value

    def attributes(self, msgs) -> dict:
        """The attribute messages in the header, then those in dense storage
        (the attribute info message's fractal heap, by the name index)."""
        out = dict(self._attribute(b) for t, _, b in msgs if t == _ATTRIBUTE)
        for t, _, b in msgs:
            if t != _ATTRIBUTE_INFO:
                continue
            if b[0] != 0:
                raise ValueError(f"{self.src.name}: attribute info message version {b[0]}")
            p = 2 + (2 if b[1] & 1 else 0)
            heap, names = _uint(b, p, self.src.o), _uint(b, p + self.src.o, self.src.o)
            if self.src.undef(heap):
                continue
            fh = self.fractal_heap(heap)
            for rec in self.btree2(names, _BT2_ATTR_NAME):
                if rec[fh.id_len] & 1:
                    raise ValueError(f"{self.src.name}: shared attribute in dense storage")
                name, value = self._attribute(fh.object(rec[: fh.id_len]))
                out[name] = value
        return out

    def convert(self, raw: np.ndarray, dtype: _Type) -> np.ndarray:
        if dtype.kind == "bool":
            return raw.view(np.int8) != 0
        if dtype.kind == "vstr":
            return self.strings(raw)
        return raw

    def group_members(self, msgs) -> dict[str, int]:
        """Link name -> object header address, of a symbol-table group or a
        new-style one (link messages, or dense links)."""
        table = [b for t, _, b in msgs if t == _SYMBOL_TABLE]
        if table:
            return self._symbol_table(table[0])
        members = dict(self._link(b) for t, _, b in msgs if t == _LINK)
        for t, _, b in msgs:
            if t != _LINK_INFO:
                continue
            if b[0] != 0:
                raise ValueError(f"{self.src.name}: link info message version {b[0]}")
            o = self.src.o
            p = 2 + (8 if b[1] & 1 else 0)
            heap, names = _uint(b, p, o), _uint(b, p + o, o)
            if self.src.undef(heap):
                continue
            fh = self.fractal_heap(heap)
            dense = dict(self._link(fh.object(rec[4:])) for rec in self.btree2(names, _BT2_LINK_NAME))
            if b[1] & 2 and not self.src.undef(order := _uint(b, p + 2 * o, o)):
                by_order = dict(self._link(fh.object(rec[8:])) for rec in self.btree2(order, _BT2_LINK_ORDER))
                if by_order != dense:
                    raise ValueError(f"{self.src.name}: a group's name and creation-order indexes disagree")
            members.update(dense)
        return members

    def _link(self, b) -> tuple[str, int]:
        """A link message: (name, the object's address) of a hard link."""
        if b[0] != 1:
            raise ValueError(f"{self.src.name}: link message version {b[0]}")
        flags, p = b[1], 2
        kind = 0
        if flags & 0x08:
            kind, p = b[p], p + 1
        p += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        n = _uint(b, p, width)
        p += width
        name = bytes(b[p : p + n]).decode("utf-8")
        if kind == 1:
            raise ValueError(f"{self.src.name}: soft link {name!r}")
        if kind != 0:
            raise ValueError(f"{self.src.name}: external (or user-defined, type {kind}) link {name!r}")
        return name, _uint(b, p + n, self.src.o)

    def _symbol_table(self, table) -> dict[str, int]:
        src = self.src
        btree, heap = _uint(table, 0, src.o), _uint(table, src.o, src.o)
        head = src.read(heap, 8 + 2 * src.l + src.o)
        if head[:4] != b"HEAP":
            raise ValueError(f"{src.name}: no local heap at address {heap}")
        names = src.read(_uint(head, 8 + 2 * src.l, src.o), _uint(head, 8, src.l))
        members: dict[str, int] = {}
        for entry in self._btree(btree, 0, 0, set()):
            off, obj, cache = _uint(entry, 0, src.o), _uint(entry, src.o, src.o), _uint(entry, 2 * src.o, 4)
            end = bytes(names[off:]).find(b"\0")
            if off >= len(names) or end < 0:
                raise ValueError(f"{src.name}: a link name outside its local heap")
            name = bytes(names[off : off + end]).decode("utf-8")
            if cache == 2:
                raise ValueError(f"{src.name}: soft link {name!r}")
            members[name] = obj
        return members

    def fractal_heap(self, addr: int) -> "_FractalHeap":
        if addr not in self.fheaps:
            self.fheaps[addr] = _FractalHeap(self.src, addr)
        return self.fheaps[addr]

    def btree2(self, addr: int, record_type: int) -> list[bytes]:
        """The records of a version-2 B-tree of ``record_type``, in key
        order."""
        src = self.src
        o, l = src.o, src.l
        head = src.read(addr, 16 + o + 2 + l + 4)
        if head[:4] != b"BTHD" or head[4] != 0:
            raise ValueError(f"{src.name}: no version-2 B-tree header (BTHD) at address {addr}")
        _checked(head, "version-2 B-tree header", src, addr)
        if head[5] != record_type:
            raise ValueError(f"{src.name}: version-2 B-tree of record type {head[5]}, {record_type} expected")
        node_size, rec, depth = _uint(head, 6, 4), _uint(head, 10, 2), _uint(head, 12, 2)
        root, root_n, total = _uint(head, 16, o), _uint(head, 16 + o, 2), _uint(head, 18 + o, l)
        if rec == 0 or node_size <= 10 + rec or depth > 32:
            raise ValueError(f"{src.name}: version-2 B-tree of node size {node_size}, record size {rec}, depth {depth}")
        # the width of each level's child pointers (H5B2hdr.c)
        max_nrec = [(node_size - 10) // rec]
        nrec_size = _enc_size(max_nrec[0])
        cum, cum_size = [max_nrec[0]], [0]
        for d in range(1, depth + 1):
            ptr = o + nrec_size + cum_size[d - 1]
            m = (node_size - 10 - ptr) // (rec + ptr)
            if m <= 0:
                raise ValueError(f"{src.name}: version-2 B-tree too deep for its node size at address {addr}")
            max_nrec.append(m)
            cum.append((m + 1) * cum[d - 1] + m)
            cum_size.append(_enc_size(cum[d]))
        out: list[bytes] = []

        def node(at: int, n: int, d: int) -> None:
            if n > max_nrec[d]:
                raise ValueError(f"{src.name}: version-2 B-tree node of {n} records at address {at}")
            sig = b"BTIN" if d else b"BTLF"
            ptr = o + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            body = src.read(at, 6 + n * rec + ((n + 1) * ptr if d else 0) + 4)
            if body[:4] != sig or body[4] != 0 or body[5] != record_type:
                raise ValueError(f"{src.name}: no version-2 B-tree node ({sig.decode()}) at address {at}")
            _checked(body, "version-2 B-tree node", src, at)
            records = [bytes(body[6 + i * rec : 6 + (i + 1) * rec]) for i in range(n)]
            if not d:
                out.extend(records)
                return
            q = 6 + n * rec
            for i in range(n + 1):
                node(_uint(body, q, o), _uint(body, q + o, nrec_size), d - 1)
                q += ptr
                if i < n:
                    out.append(records[i])

        if root_n:
            if src.undef(root):
                raise ValueError(f"{src.name}: version-2 B-tree of {root_n} root records without a root node")
            node(root, root_n, depth)
        if len(out) != total:
            raise ValueError(f"{src.name}: version-2 B-tree of {len(out)} records, its header says {total}")
        return out

    def _btree(self, addr: int, node_type: int, ndims: int, seen: set, depth: int = 0):
        """The leaf entries of a version-1 B-tree, in key order: symbol
        table entries (group nodes), or (key bytes, chunk address)."""
        src = self.src
        if addr in seen or depth > 64:
            raise ValueError(f"{src.name}: B-tree cycle at address {addr}")
        seen.add(addr)
        head = src.read(addr, 8 + 2 * src.o)
        if head[:4] != b"TREE" or head[4] != node_type:
            raise ValueError(f"{src.name}: no version-1 B-tree node (type {node_type}) at address {addr}")
        level, used = head[5], _uint(head, 6, 2)
        key_n = src.l if node_type == 0 else 8 + 8 * ndims
        body = src.read(addr + 8 + 2 * src.o, used * (key_n + src.o) + key_n)
        for i in range(used):
            p = i * (key_n + src.o)
            child = _uint(body, p + key_n, src.o)
            if level:
                yield from self._btree(child, node_type, ndims, seen, depth + 1)
            elif node_type == 1:
                yield bytes(body[p : p + key_n]), child
            else:
                node = src.read(child, 8)
                if node[:4] != b"SNOD":
                    raise ValueError(f"{src.name}: no symbol table node at address {child}")
                n = _uint(node, 6, 2)
                size = 2 * src.o + 24
                entries = src.read(child + 8, n * size)
                for j in range(n):
                    yield entries[j * size : (j + 1) * size]

    def chunks(self, addr: int, ndims: int):
        yield from self._btree(addr, 1, ndims, set())


class Dataset:
    """A dataset: ``shape``, ``dtype`` (as it reads: ``bool`` for h5py's
    enum, ``object`` for variable-length strings), ``attrs``; ``[()]`` /
    ``[:]`` / ``read()`` give the whole array."""

    def __init__(self, reader: _Reader, name: str, msgs):
        self._reader, self.name = reader, name
        src = reader.src
        found = {t: b for t, _, b in msgs if t != _ATTRIBUTE}
        self.attrs = reader.attributes(msgs)
        if _DATASPACE not in found or _DATATYPE not in found:
            raise ValueError(f"{src.name}: dataset {name!r} without a dataspace or datatype")
        shape = _parse_dataspace(found[_DATASPACE], src)
        self.shape = () if shape is None else shape
        self.maxshape = _parse_dataspace(found[_DATASPACE], src, maxshape=True) or self.shape
        self._type, _ = _parse_datatype(found[_DATATYPE], 0, src)
        self.dtype = self._type.dtype
        self._layout = found[_LAYOUT]
        self._pipeline = _parse_pipeline(found.get(_PIPELINE), src.name)
        self._fill = _fill_value(found.get(_FILL), found.get(_FILL_OLD), self._type)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def __getitem__(self, key):
        arr = self.read()
        if key == () or key == slice(None):
            return arr[()] if not self.shape else arr
        return arr[key]

    def read(self) -> np.ndarray:
        src, t = self._reader.src, self._type
        nbytes = self.size * t.size
        if nbytes > _MAX_EXPANSION * src.size + (1 << 20):
            raise ValueError(f"{src.name}: dataset {self.name!r} of shape {self.shape} cannot come from this file")
        b = self._layout
        version, cls = b[0], b[1] if len(b) > 1 else -1
        if version not in (3, 4):
            raise ValueError(f"{src.name}: data layout message version {version} in dataset {self.name!r}")
        if cls == 0:
            n = _uint(b, 2, 2)
            raw = bytes(b[4 : 4 + n])
            if n != nbytes or len(raw) != n:
                raise ValueError(f"{src.name}: compact dataset {self.name!r} of {n} bytes, {nbytes} expected")
            out = np.frombuffer(raw, dtype=t.storage).reshape(self.shape).copy()
        elif cls == 1:
            addr, n = _uint(b, 2, src.o), _uint(b, 2 + src.o, src.l)
            if src.undef(addr):
                out = self._filled()
            elif n != nbytes:
                raise ValueError(f"{src.name}: contiguous dataset {self.name!r} of {n} bytes, {nbytes} expected")
            else:
                out = np.frombuffer(src.view(addr, n), dtype=t.storage).reshape(self.shape).copy()
        elif cls == 2:
            out = self._read_chunked(b)
        else:
            raise ValueError(f"{src.name}: data layout class {cls} in dataset {self.name!r}")
        return self._reader.convert(out, t)

    def _filled(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self._type.storage)
        if self._fill is not None:
            out[...] = np.frombuffer(self._fill, dtype=self._type.storage)[0]
        return out

    def _read_chunked(self, b) -> np.ndarray:
        src, t = self._reader.src, self._type
        if b[0] == 3:
            rank, p = b[2] - 1, 3
            addr = _uint(b, p, src.o)
            dims = [_uint(b, p + src.o + 4 * i, 4) for i in range(rank + 1)]
            flags = 0
        else:
            flags, rank, width = b[2], b[3] - 1, b[4]
            dims = [_uint(b, 5 + width * i, width) for i in range(rank + 1)]
            p = 5 + width * (rank + 1)
        if rank != len(self.shape) or dims[-1] != t.size or 0 in dims:
            raise ValueError(f"{src.name}: chunk shape {dims} does not fit dataset {self.name!r} {self.shape}")
        chunk = tuple(dims[:rank])
        chunk_bytes = math.prod(chunk) * t.size
        out = self._filled()
        if not self.size:
            return out
        if b[0] == 3:
            entries = [] if src.undef(addr) else self._btree1_chunks(addr, rank, chunk)
        else:
            entries = self._indexed_chunks(b, p, rank, chunk, chunk_bytes)
        for offset, _, _, _ in entries:
            if any(o % c or o >= s for o, c, s in zip(offset, chunk, self.shape)):
                raise ValueError(f"{src.name}: chunk at {offset} outside dataset {self.name!r} {self.shape}")
        pipeline, name = self._pipeline, self.name
        # partial edge chunks stored without filters (layout 4 flag bit 0)
        edge_unfiltered = bool(flags & 1) and bool(pipeline)

        def one(entry):
            offset, size, mask, child = entry
            if edge_unfiltered and any(o + c > s for o, c, s in zip(offset, chunk, self.shape)):
                mask = (1 << len(pipeline)) - 1
            data = _unfilter(bytes(src.view(child, size)), pipeline, mask, chunk_bytes, f"{src.name}: {name!r}")
            arr = np.frombuffer(data, dtype=t.storage).reshape(chunk)
            region = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offset, chunk, self.shape))
            out[region] = arr[tuple(slice(0, r.stop - r.start) for r in region)]

        self._reader.map(one, entries)
        return out

    def _btree1_chunks(self, addr: int, rank: int, chunk: tuple) -> list:
        """(element offset, stored size, filter mask, address) of each chunk
        in a version-1 B-tree."""
        out = []
        for key, child in self._reader.chunks(addr, rank + 1):
            size, mask = _uint(key, 0, 4), _uint(key, 4, 4)
            out.append((tuple(_uint(key, 8 + 8 * i, 8) for i in range(rank)), size, mask, child))
        return out

    def _indexed_chunks(self, b, p: int, rank: int, chunk: tuple, chunk_bytes: int) -> list:
        """The chunks of a version-4 layout's chunk index: (element offset,
        stored size, filter mask, address)."""
        reader, src = self._reader, self._reader.src
        o, l = src.o, src.l
        filtered = bool(self._pipeline)
        kind = b[p]
        # the chunk grid over the largest shape, row-major (H5VM_array_offset_pre)
        grid = [-1 if m < 0 else -(-m // c) for m, c in zip(self.maxshape, chunk)]

        def at_index(i: int) -> tuple:
            coords = []
            for g in reversed(grid[1:]):
                i, r = divmod(i, g)
                coords.append(r)
            return (i, *reversed(coords))

        def entry(grid_coords, raw, q=0) -> tuple | None:
            addr = _uint(raw, q, o)
            if src.undef(addr):
                return None
            offset = tuple(g * c for g, c in zip(grid_coords, chunk))
            if any(x >= s for x, s in zip(offset, self.shape)):
                return None  # a chunk of the largest shape outside the current one
            if not filtered:
                return offset, chunk_bytes, 0, addr
            n = len(raw) - q - o - 4
            return offset, _uint(raw, q + o, n), _uint(raw, q + o + n, 4), addr

        if kind == 1:  # single chunk
            if b[2] & 2:
                size, mask, addr = _uint(b, p + 1, l), _uint(b, p + 1 + l, 4), _uint(b, p + 5 + l, o)
            else:
                size, mask, addr = chunk_bytes, 0, _uint(b, p + 1, o)
            return [] if src.undef(addr) else [((0,) * rank, size, mask, addr)]
        if kind == 2:  # implicit: every chunk in grid order from one address
            addr = _uint(b, p + 1, o)
            if src.undef(addr):
                return []
            if math.prod(grid) * chunk_bytes > src.size:
                raise ValueError(f"{src.name}: implicit chunk index of {math.prod(grid)} chunks past the file's end")
            out = []
            for i in range(math.prod(grid)):
                offset = tuple(g * c for g, c in zip(at_index(i), chunk))
                if all(x < s for x, s in zip(offset, self.shape)):
                    out.append((offset, chunk_bytes, 0, addr + i * chunk_bytes))
            return out
        if kind == 3:  # fixed array
            addr = _uint(b, p + 2, o)
            if src.undef(addr):
                return []
            return [e for i, raw in _fixed_array(src, addr) if (e := entry(at_index(i), raw))]
        if kind == 4:  # extensible array (one unlimited dimension)
            if grid[0] != -1 or -1 in grid[1:]:
                raise ValueError(f"{src.name}: extensible-array chunk index over unlimited dimension other than the "
                                 f"first in dataset {self.name!r}")
            addr = _uint(b, p + 6, o)
            if src.undef(addr):
                return []
            return [e for i, raw in _extensible_array(src, addr) if (e := entry(at_index(i), raw))]
        if kind == 5:  # version-2 B-tree (several unlimited dimensions)
            addr = _uint(b, p + 7, o)
            if src.undef(addr):
                return []
            out = []
            for rec in reader.btree2(addr, _BT2_CHUNK_FILTERED if filtered else _BT2_CHUNK):
                scaled = tuple(_uint(rec, len(rec) - 8 * (rank - i), 8) for i in range(rank))
                e = entry(scaled, rec[: len(rec) - 8 * rank])
                if e:
                    out.append(e)
            return out
        raise ValueError(f"{src.name}: chunk index type {kind} in dataset {self.name!r}")


def _array_header(src: _Source, addr: int, sig: bytes, size: int) -> bytes:
    block = src.read(addr, size)
    if block[:4] != sig or block[4] != 0:
        raise ValueError(f"{src.name}: no {sig.decode()} block at address {addr}")
    _checked(block, f"{sig.decode()} block", src, addr)
    return block


def _bit(bitmap, i: int) -> bool:
    """HDF5's bitmaps: bit 0 the most significant of byte 0."""
    return bool(bitmap[i // 8] & (0x80 >> (i % 8)))


def _fixed_array(src: _Source, addr: int):
    """(index, element bytes) of every element of a fixed array (its data
    block, or the data block's pages that are initialised)."""
    o, l = src.o, src.l
    head = _array_header(src, addr, b"FAHD", 8 + l + o + 4)
    esize, page_bits, n, dblock = head[6], head[7], _uint(head, 8, l), _uint(head, 8 + l, o)
    if src.undef(dblock) or not n:
        return
    if n > _MAX_EXPANSION * src.size or page_bits > 32 or esize < o:
        raise ValueError(f"{src.name}: fixed array of {n} entries of {esize} bytes at address {addr}")
    page = 1 << page_bits
    if n <= page:
        block = _array_header(src, dblock, b"FADB", 6 + o + n * esize + 4)
        for i in range(n):
            yield i, block[6 + o + i * esize : 6 + o + (i + 1) * esize]
        return
    pages = -(-n // page)
    bitmap_n = (pages + 7) // 8
    block = _array_header(src, dblock, b"FADB", 6 + o + bitmap_n + 4)
    bitmap = block[6 + o : 6 + o + bitmap_n]
    first = dblock + 6 + o + bitmap_n + 4
    for k in range(pages):
        if not _bit(bitmap, k):
            continue
        count = min(page, n - k * page)
        body = src.read(first + k * (page * esize + 4), count * esize + 4)
        _checked(body, "fixed array data block page", src, first + k * (page * esize + 4))
        for i in range(count):
            yield k * page + i, body[i * esize : (i + 1) * esize]


def _extensible_array(src: _Source, addr: int):
    """(index, element bytes) of every element set in an extensible array:
    the index block's elements and data blocks, the super blocks' data
    blocks and their pages (``H5EA``)."""
    o, l = src.o, src.l
    head = _array_header(src, addr, b"EAHD", 12 + 6 * l + o + 4)
    esize, max_bits, idx_n, min_elmts, min_ptrs, page_bits = head[6], head[7], head[8], head[9], head[10], head[11]
    n_set, iblock = _uint(head, 12 + 4 * l, l), _uint(head, 12 + 6 * l, o)
    pow2 = lambda v: v > 0 and v & (v - 1) == 0  # noqa: E731
    if src.undef(iblock) or not n_set:
        return
    if not (pow2(min_elmts) and pow2(min_ptrs)) or esize < o or max_bits > 64 or page_bits > 32:
        raise ValueError(f"{src.name}: extensible array of element size {esize} at address {addr}")
    off_n = (max_bits + 7) // 8
    page = 1 << page_bits
    n_sblk = 1 + max_bits - (min_elmts.bit_length() - 1)
    sblk, start_idx, start_dblk = [], 0, 0
    for u in range(n_sblk):
        ndblk, nelm = 1 << (u // 2), (1 << ((u + 1) // 2)) * min_elmts
        sblk.append((ndblk, nelm, start_idx, start_dblk))
        start_idx += ndblk * nelm
        start_dblk += ndblk
    in_index = 2 * (min_ptrs.bit_length() - 1)
    n_dblk_addr, n_sblk_addr = 2 * (min_ptrs - 1), n_sblk - in_index
    ib = _array_header(src, iblock, b"EAIB", 6 + o + idx_n * esize + (n_dblk_addr + n_sblk_addr) * o + 4)
    p = 6 + o
    for i in range(min(idx_n, n_set)):
        yield i, ib[p + i * esize : p + (i + 1) * esize]
    p += idx_n * esize
    dblk_addr = [_uint(ib, p + i * o, o) for i in range(n_dblk_addr)]
    sblk_addr = [_uint(ib, p + (n_dblk_addr + i) * o, o) for i in range(n_sblk_addr)]

    def data_block(at: int, nelm: int, first: int, bitmap=None, bit0=0):
        prefix = 6 + o + off_n
        if nelm <= page:
            block = _array_header(src, at, b"EADB", prefix + nelm * esize + 4)
            for i in range(min(nelm, n_set - first)):
                yield first + i, block[prefix + i * esize : prefix + (i + 1) * esize]
            return
        if bitmap is None:
            raise ValueError(f"{src.name}: paged extensible-array data block in its index block at address {at}")
        _array_header(src, at, b"EADB", prefix + 4)
        for k in range(nelm // page):
            if not _bit(bitmap, bit0 + k) or first + k * page >= n_set:
                continue
            pa = at + prefix + 4 + k * (page * esize + 4)
            body = src.read(pa, page * esize + 4)
            _checked(body, "extensible array data block page", src, pa)
            for i in range(min(page, n_set - first - k * page)):
                yield first + k * page + i, body[i * esize : (i + 1) * esize]

    for u, (ndblk, nelm, s_idx, s_dblk) in enumerate(sblk):
        base = idx_n + s_idx
        if base >= n_set:
            break
        if u < in_index:
            for j in range(ndblk):
                a = dblk_addr[s_dblk + j]
                if not src.undef(a):
                    yield from data_block(a, nelm, base + j * nelm)
            continue
        a = sblk_addr[u - in_index]
        if src.undef(a):
            continue
        npages = nelm // page if nelm > page else 0
        bitmap_n = ndblk * ((npages + 7) // 8) if npages else 0
        sb = _array_header(src, a, b"EASB", 6 + o + off_n + bitmap_n + ndblk * o + 4)
        bitmap = sb[6 + o + off_n : 6 + o + off_n + bitmap_n]
        q = 6 + o + off_n + bitmap_n
        for j in range(ndblk):
            da = _uint(sb, q + j * o, o)
            if not src.undef(da):
                yield from data_block(da, nelm, base + j * nelm, bitmap if npages else None, j * npages)


def _parse_pipeline(b, name: str) -> list[tuple[int, int, tuple]]:
    """[(filter id, flags, client data)] in the order they were applied."""
    if b is None:
        return []
    version, n = b[0], b[1]
    p = 8 if version == 1 else 2
    if version not in (1, 2):
        raise ValueError(f"{name}: filter pipeline message version {version}")
    out = []
    for _ in range(n):
        fid = _uint(b, p, 2)
        if version == 1 or fid >= 256:
            name_n = _uint(b, p + 2, 2)
            flags, ncd = _uint(b, p + 4, 2), _uint(b, p + 6, 2)
            p += 8 + (name_n if version == 2 else (name_n + 7) // 8 * 8)
        else:
            name_n = 0
            flags, ncd = _uint(b, p + 2, 2), _uint(b, p + 4, 2)
            p += 6
        cd = tuple(_uint(b, p + 4 * i, 4) for i in range(ncd))
        p += 4 * ncd + (4 if version == 1 and ncd % 2 else 0)
        if fid not in (1, 2, 3, 32000):
            raise ValueError(f"{name}: filter {_FILTER_NAMES.get(fid, 'id')} ({fid}) is not supported")
        out.append((fid, flags, cd))
    return out


def _fill_value(new, old, t: _Type) -> bytes | None:
    value = None
    if new is not None:
        version = new[0]
        if version in (1, 2):
            defined = new[3]
            if version == 1 or defined:
                n = _uint(new, 4, 4)
                value = bytes(new[8 : 8 + n]) if n else None
        elif version == 3:
            if new[1] & 0x20:
                n = _uint(new, 2, 4)
                value = bytes(new[6 : 6 + n]) if n else None
    elif old is not None:
        n = _uint(old, 0, 4)
        value = bytes(old[4 : 4 + n]) if n else None
    if value is not None and (len(value) != t.size or t.kind == "vstr"):
        return None
    return value


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 of ``data``: big-endian 16-bit words, sums in
    ones'-complement arithmetic modulo 65535 (0 only for all-zero data)."""
    if len(data) % 2:
        data = data + b"\0"
    w = np.frombuffer(data, dtype=">u2").astype(np.uint64)
    n = len(w)
    s1 = int(w.sum())
    weights = (np.arange(n, 0, -1, dtype=np.uint64) % 65535)
    s2 = int(((w % 65535) * weights).sum())

    if s1 == 0:
        return 0
    return (((s2 - 1) % 65535 + 1) << 16) | ((s1 - 1) % 65535 + 1)


def _unshuffle(data: bytes, size: int) -> bytes:
    n = len(data) // size
    if size <= 1 or n <= 1:
        return data
    body = np.frombuffer(data, dtype=np.uint8, count=n * size).reshape(size, n).T.tobytes()
    return body + data[n * size :]


def _shuffle(data: bytes, size: int) -> bytes:
    n = len(data) // size
    if size <= 1 or n <= 1:
        return data
    body = np.frombuffer(data, dtype=np.uint8, count=n * size).reshape(n, size).T.tobytes()
    return body + data[n * size :]


def lzf_decompress(src: bytes, limit: int) -> bytes:
    """liblzf's format: a control byte < 32 starts a literal run of c + 1
    bytes; else a back reference of length (c >> 5) + 2 (7: one more length
    byte) at distance ((c & 31) << 8) + next byte + 1."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        i += 1
        if c < 32:
            if i + c + 1 > n:
                raise ValueError("LZF: a literal run past the input's end")
            out += src[i : i + c + 1]
            i += c + 1
        else:
            length = c >> 5
            if length == 7:
                if i >= n:
                    raise ValueError("LZF: a truncated back reference")
                length += src[i]
                i += 1
            if i >= n:
                raise ValueError("LZF: a truncated back reference")
            ref = len(out) - ((c & 0x1F) << 8) - src[i] - 1
            i += 1
            if ref < 0:
                raise ValueError("LZF: a back reference before the output's start")
            length += 2
            dist = len(out) - ref
            if dist >= length:
                out += out[ref : ref + length]
            else:
                out += (out[ref:] * (length // dist + 1))[:length]
        if len(out) > limit:
            raise ValueError("LZF: output past the chunk's size")
    return bytes(out)


def _unfilter(data: bytes, pipeline, mask: int, chunk_bytes: int, where: str) -> bytes:
    try:
        for index in range(len(pipeline) - 1, -1, -1):
            if mask & (1 << index):
                continue
            fid, _, cd = pipeline[index]
            if fid == 1:
                d = zlib.decompressobj()
                data = d.decompress(data, chunk_bytes + 1)
                if d.unconsumed_tail or not d.eof:
                    raise ValueError("deflate stream longer than the chunk or truncated")
            elif fid == 2:
                data = _unshuffle(data, cd[0] if cd else 1)
            elif fid == 3:
                if len(data) < 4:
                    raise ValueError("fletcher32: chunk shorter than its checksum")
                stored = int.from_bytes(data[-4:], "little")
                data = data[:-4]
                sum_ = fletcher32(data)
                swapped = int.from_bytes(sum_.to_bytes(4, "little"), "big")
                if stored not in (sum_, swapped):
                    raise ValueError(f"fletcher32 checksum mismatch (stored {stored:#010x}, computed {sum_:#010x})")
            else:
                data = lzf_decompress(data, chunk_bytes)
    except zlib.error as e:
        raise ValueError(f"{where}: deflate: {e}") from None
    except ValueError as e:
        raise ValueError(f"{where}: {e}") from None
    if len(data) != chunk_bytes:
        raise ValueError(f"{where}: a chunk of {len(data)} bytes after its filters, {chunk_bytes} expected")
    return data


class Group:
    """A group. Read from a file: ``attrs``, ``in``, ``[name]``, iteration
    over member names in name order (h5py's order for these groups). Built
    for the writer: ``Group(attrs)``, ``create_group``, ``create_dataset``."""

    def __init__(self, attrs: dict | None = None, *, _reader=None, _msgs=None, _name="/"):
        self._reader, self.name = _reader, _name
        if _reader is None:
            self.attrs = dict(attrs or {})
            self._members: dict = {}
        else:
            self.attrs = _reader.attributes(_msgs)
            self._members = _reader.group_members(_msgs)

    # -- both ------------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._members

    def __iter__(self):
        return iter(sorted(self._members, key=lambda k: k.encode("utf-8")))

    def __len__(self) -> int:
        return len(self._members)

    def __getitem__(self, name: str):
        node = self
        for part in [p for p in name.split("/") if p]:
            node = node._child(part)
        return node

    def _child(self, name: str):
        if name not in self._members:
            raise KeyError(f"{name!r} not in group {self.name!r}")
        member = self._members[name]
        if self._reader is None:
            return member
        msgs = self._reader.messages(member)
        path = f"{self.name.rstrip('/')}/{name}"
        if any(t in (_SYMBOL_TABLE, _LINK_INFO) for t, _, _ in msgs):
            return Group(_reader=self._reader, _msgs=msgs, _name=path)
        if any(t == _LAYOUT for t, _, _ in msgs):
            return Dataset(self._reader, path, msgs)
        raise ValueError(f"{self._reader.src.name}: {path!r} is neither a group nor a dataset (a committed datatype?)")

    # -- writing ---------------------------------------------------------
    def create_group(self, name: str, attrs: dict | None = None) -> "Group":
        g = Group(attrs)
        self._add(name, g)
        return g

    def create_dataset(self, name: str, data, attrs: dict | None = None) -> "WDataset":
        d = WDataset(data, attrs)
        self._add(name, d)
        return d

    def _add(self, name: str, node) -> None:
        if self._reader is not None:
            raise ValueError("groups read from a file are read-only")
        if not name or "/" in name or name in self._members:
            raise ValueError(f"bad or repeated member name {name!r}")
        self._members[name] = node


class File(Group):
    """An HDF5 file opened for reading (a context manager)."""

    def __init__(self, path, threads: int = 1):
        self.path = Path(path)
        self._fh = open(self.path, "rb")
        try:
            size = os.fstat(self._fh.fileno()).st_size
            buf = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ) if size else b""
            self._mm = buf if size else None
            src = _Source(buf, str(self.path))
            root, ext = _superblock(src)
            reader = _Reader(src, max(1, int(threads)))
            if ext is not None and not src.undef(ext):
                reader.messages(ext)  # the superblock extension: a shared message table raises
            super().__init__(_reader=reader, _msgs=reader.messages(root), _name="/")
        except (struct.error, IndexError, OverflowError, UnicodeDecodeError, RecursionError) as e:
            self.close()
            raise ValueError(f"{self.path}: corrupt HDF5 file ({type(e).__name__}: {e})") from None
        except BaseException:
            self.close()
            raise

    def __getitem__(self, name: str):
        try:
            return super().__getitem__(name)
        except (struct.error, IndexError, OverflowError, UnicodeDecodeError, RecursionError) as e:
            raise ValueError(f"{self.path}: corrupt HDF5 file ({type(e).__name__}: {e})") from None

    def close(self) -> None:
        if getattr(self, "_reader", None) is not None:
            self._reader.close()
        mm, self._mm = getattr(self, "_mm", None), None
        if mm is not None:
            mm.close()
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _superblock(src: _Source) -> tuple[int, int | None]:
    """Find the superblock (at 0, 512, 1024, ...), set the source's base
    and sizes; return the root group's object header address and the
    superblock extension's (``None`` before version 2)."""
    at = 0
    while at + 8 <= src.size and src.buf[at : at + 8] != SIGNATURE:
        at = 512 if at == 0 else at * 2
    if at + 8 > src.size:
        raise ValueError(f"{src.name}: not an HDF5 file (no superblock signature)")
    head = src.read(at, 24)
    version = head[8]
    if version in (2, 3):
        src.o, src.l = head[9], head[10]
        if src.o not in (2, 4, 8) or src.l not in (2, 4, 8):
            raise ValueError(f"{src.name}: superblock with {src.o}-byte offsets and {src.l}-byte lengths")
        o = src.o
        block = src.read(at, 12 + 4 * o + 4)
        _checked(block, f"version-{version} superblock", src, at)
        base, ext, eof, root = (_uint(block, 12 + i * o, o) for i in range(4))
    elif version in (0, 1):
        src.o, src.l = head[13], head[14]
        if src.o not in (2, 4, 8) or src.l not in (2, 4, 8):
            raise ValueError(f"{src.name}: superblock with {src.o}-byte offsets and {src.l}-byte lengths")
        p = at + 24 + (4 if version == 1 else 0)
        o = src.o
        fields = src.read(p, 4 * o + 2 * o + 24)
        base, eof, root, ext = _uint(fields, 0, o), _uint(fields, 2 * o, o), _uint(fields, 4 * o + o, o), None
    else:
        raise ValueError(f"{src.name}: superblock version {version}")
    if base != at:
        raise ValueError(f"{src.name}: superblock at {at} with base address {base}")
    src.base = base
    if eof > src.size:
        raise ValueError(f"{src.name}: truncated: end-of-file address {eof} past the file's {src.size} bytes")
    return root, ext


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------
_O = 8  # offsets and lengths of the files written
_UNDEF = (1 << 64) - 1
_GROUP_LEAF_K, _GROUP_NODE_K, _CHUNK_K = 4, 16, 32
_CHUNK_BASE, _CHUNK_MIN, _CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024


def guess_chunk(shape: tuple, typesize: int) -> tuple:
    """h5py's chunk shape for a dataset (``h5py._hl.filters.guess_chunk``):
    halve the axes in turn until a chunk is near a target that grows with
    the dataset, from 8 KiB to under 1 MiB."""
    chunks = np.array([x if x != 0 else 1024 for x in shape], dtype="=f8")
    dset_size = float(np.prod(chunks)) * typesize
    target = _CHUNK_BASE * (2 ** np.log10(dset_size / (1024.0 * 1024)))
    target = min(max(target, _CHUNK_MIN), _CHUNK_MAX)
    idx = 0
    while True:
        chunk_bytes = float(np.prod(chunks)) * typesize
        if (chunk_bytes < target or abs(chunk_bytes - target) / target < 0.5) and chunk_bytes < _CHUNK_MAX:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % len(shape)] = np.ceil(chunks[idx % len(shape)] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


class WDataset:
    """A dataset to write: ``data`` (numpy array or scalar) and its
    attributes; an array is chunked under deflate level 1, a scalar
    contiguous."""

    def __init__(self, data, attrs: dict | None = None):
        arr = np.asarray(data)
        if arr.dtype.kind == "U":
            arr = arr.astype(object)
        self.data, self.attrs = arr, dict(attrs or {})
        self.dtype, self.shape = arr.dtype, arr.shape


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _encode_datatype(dtype: np.dtype) -> bytes:
    """The datatype message of a numpy dtype (version 1 of each class)."""
    dtype = np.dtype(dtype)
    if dtype.kind == "b":
        base = _encode_datatype(np.dtype(np.int8))
        names = _pad8(b"FALSE\0") + _pad8(b"TRUE\0")
        return struct.pack("<BBBBI", 0x18, 2, 0, 0, 1) + base + names + bytes([0, 1])
    if dtype.kind in "iu":
        if dtype.byteorder == ">":
            raise ValueError(f"big-endian dtype {dtype} is not written")
        bits = 0x08 if dtype.kind == "i" else 0
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, dtype.itemsize, 0, 8 * dtype.itemsize)
    if dtype.kind == "f" and dtype.itemsize in _IEEE:
        if dtype.byteorder == ">":
            raise ValueError(f"big-endian dtype {dtype} is not written")
        off, prec, eloc, esz, mloc, msz, bias, sign = _IEEE[dtype.itemsize]
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, dtype.itemsize, off, prec, eloc, esz, mloc, msz, bias)
    if dtype.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, max(dtype.itemsize, 1))
    if dtype.kind == "O":
        base = struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + base
    raise ValueError(f"dtype {dtype} is outside the written subset")


def _encode_dataspace(shape: tuple) -> bytes:
    head = struct.pack("<BBBB4x", 1, len(shape), 1 if shape else 0, 0)
    return head + b"".join(struct.pack("<Q", d) for d in shape) * (2 if shape else 1)


def _storage_size(dtype: np.dtype) -> int:
    return 16 if dtype.kind == "O" else max(dtype.itemsize, 1)


class _Out:
    """The output file with its write position."""

    def __init__(self, fh, pool: ThreadPoolExecutor, threads: int):
        self.fh, self.pos, self.pool, self.threads = fh, 0, pool, threads

    def put(self, data: bytes) -> int:
        addr = self.pos
        self.fh.write(data)
        self.pos += len(data)
        return addr

    def strings(self, values) -> bytes:
        """Variable-length records of ``values`` (``str`` each), their
        bytes in global heap collections written now."""
        blobs = [str(v).encode("utf-8") for v in values]
        records = [None] * len(blobs)
        start = 0
        while start < len(blobs):
            # a collection holds at most 65,535 objects (the index is 16-bit)
            stop, size = start, 16
            while stop < len(blobs) and stop - start < 65535 and (size < (1 << 30) or stop == start):
                size += 16 + (len(blobs[stop]) + 7) // 8 * 8
                stop += 1
            total = max(4096, size + 16)
            body = bytearray(b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", total))
            for i in range(start, stop):
                body += struct.pack("<HH4xQ", i - start + 1, 1, len(blobs[i])) + _pad8(blobs[i])
            free = total - len(body)
            if free >= 16:
                body += struct.pack("<HH4xQ", 0, 0, free)
            body += b"\0" * (total - len(body))
            addr = self.put(bytes(body))
            for i in range(start, stop):
                records[i] = (len(blobs[i]), addr, i - start + 1)
            start = stop
        return b"".join(struct.pack("<IQI", n, a, k) if n else struct.pack("<IQI", 0, 0, 0) for n, a, k in records)

    def raw(self, arr: np.ndarray) -> bytes:
        if arr.dtype.kind == "O":
            return self.strings(arr.reshape(-1))
        if arr.dtype.kind == "b":
            return arr.astype(np.int8).tobytes()
        return np.ascontiguousarray(arr).tobytes()


def _attribute_message(out: _Out, name: str, value) -> bytes:
    if isinstance(value, str) or (isinstance(value, (list, tuple)) and all(isinstance(v, str) for v in value) and value):
        arr = np.array(value, dtype=object)
    else:
        arr = np.asarray(value)
        if arr.dtype.kind == "U":
            arr = arr.astype(object)
    dt, ds = _encode_datatype(arr.dtype), _encode_dataspace(arr.shape)
    name_b = name.encode("utf-8") + b"\0"
    head = struct.pack("<BBHHH", 1, 0, len(name_b), len(dt), len(ds))
    return _pad8(head + _pad8(name_b) + _pad8(dt) + _pad8(ds) + out.raw(arr))


def _object_header(messages: list[tuple[int, bytes]]) -> bytes:
    body = b"".join(struct.pack("<HHB3x", t, len(_pad8(m)), 0) + _pad8(m) for t, m in messages)
    if len(body) > 0xFFFFFFFF or any(len(_pad8(m)) > 0xFFFF for _, m in messages):
        raise ValueError("an object header message of more than 64 KiB (an attribute too large)")
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _btree_nodes(out: _Out, node_type: int, entries: list[tuple[bytes, int]], last_key: bytes, k: int) -> int:
    """Write a version-1 B-tree over ``entries`` [(left key, child)] with
    ``last_key`` after the last child; every node at its full size of 2k
    entries. Return the root's address."""
    key_n = len(last_key)
    node_size = 8 + 2 * _O + (2 * k + 1) * key_n + 2 * k * _O
    level = 0
    while True:
        groups = [entries[i : i + 2 * k] for i in range(0, len(entries), 2 * k)] or [[]]
        addrs = [out.pos + i * node_size for i in range(len(groups))]
        parents = []
        for i, g in enumerate(groups):
            left = addrs[i - 1] if i else _UNDEF
            right = addrs[i + 1] if i + 1 < len(groups) else _UNDEF
            body = bytearray(b"TREE" + bytes([node_type, level]) + struct.pack("<HQQ", len(g), left, right))
            for key, child in g:
                body += key + struct.pack("<Q", child)
            body += groups[i + 1][0][0] if i + 1 < len(groups) else last_key
            body += b"\0" * (node_size - len(body))
            out.put(bytes(body))
            if g:
                parents.append((g[0][0], addrs[i]))
        if len(groups) == 1:
            return addrs[0]
        entries, level = parents, level + 1


def _write_dataset(out: _Out, d: WDataset) -> int:
    arr, dtype = d.data, d.dtype
    size = _storage_size(dtype)
    messages = [(_DATASPACE, _encode_dataspace(arr.shape)), (_DATATYPE, _encode_datatype(dtype))]
    if not arr.shape:
        raw = out.raw(arr)
        addr = out.put(raw) if raw else _UNDEF
        messages.append((_FILL, bytes([2, 2, 2, 1]) + struct.pack("<I", 0)))
        messages.append((_LAYOUT, struct.pack("<BBQQ", 3, 1, addr, len(raw))))
    else:
        chunk = guess_chunk(arr.shape, size)
        offsets = list(np.ndindex(*[-(-n // c) for n, c in zip(arr.shape, chunk)])) if arr.size else []

        def pack(index):
            start = [i * c for i, c in zip(index, chunk)]
            part = arr[tuple(slice(s, s + c) for s, c in zip(start, chunk))]
            if part.shape != chunk:
                full = np.zeros(chunk, dtype=arr.dtype if dtype.kind != "O" else object)
                if dtype.kind == "O":
                    full[...] = ""
                full[tuple(slice(0, n) for n in part.shape)] = part
                part = full
            return start, part

        entries = []
        batch = out.threads * 8
        for b0 in range(0, len(offsets), batch):
            parts = [pack(i) for i in offsets[b0 : b0 + batch]]
            raws = [out.raw(p) for _, p in parts]
            packed = list(out.pool.map(lambda r: zlib.compress(r, 1), raws)) if out.threads > 1 else [
                zlib.compress(r, 1) for r in raws
            ]
            for (start, _), z in zip(parts, packed):
                key = struct.pack("<II", len(z), 0) + b"".join(struct.pack("<Q", s) for s in start) + b"\0" * 8
                entries.append((key, out.put(z)))
        if entries:
            last = [i * c for i, c in zip(offsets[-1], chunk)]
            last_key = struct.pack("<II", 0, 0) + b"".join(struct.pack("<Q", s + c) for s, c in zip(last, chunk))
            last_key += struct.pack("<Q", size)
            root = _btree_nodes(out, 1, entries, last_key, _CHUNK_K)
        else:
            root = _UNDEF
        messages.append((_FILL, bytes([2, 3, 2, 1]) + struct.pack("<I", 0)))
        layout = struct.pack("<BBBQ", 3, 2, len(chunk) + 1, root) + b"".join(struct.pack("<I", c) for c in chunk)
        messages.append((_LAYOUT, layout + struct.pack("<I", size)))
        deflate = struct.pack("<HHHH", 1, 8, 1, 1) + _pad8(b"deflate\0") + struct.pack("<I4x", 1)
        messages.append((_PIPELINE, struct.pack("<BB6x", 1, 1) + deflate))
    messages += [(_ATTRIBUTE, _attribute_message(out, k, v)) for k, v in d.attrs.items()]
    return out.put(_object_header(messages))


def _write_group(out: _Out, g: Group) -> tuple[int, int, int]:
    """Write a group's members, then its heap, symbol table nodes, B-tree
    and object header. Return (header, B-tree, heap) addresses."""
    names = sorted(g._members, key=lambda k: k.encode("utf-8"))
    children = []
    for name in names:
        node = g._members[name]
        if isinstance(node, Group):
            children.append((name, *_write_group(out, node)))
        else:
            children.append((name, _write_dataset(out, node), None, None))
    heap_data, offsets = bytearray(8), []
    for name, *_ in children:
        offsets.append(len(heap_data))
        heap_data += _pad8(name.encode("utf-8") + b"\0")
    heap = out.put(b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack("<QQQ", len(heap_data), 1, out.pos + 32))
    out.put(bytes(heap_data))

    leaves = []
    per_node = 2 * _GROUP_LEAF_K
    for i in range(0, len(children), per_node):
        part = list(zip(offsets, children))[i : i + per_node]
        body = bytearray(b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(part)))
        for off, (_, header, btree, lheap) in part:
            if btree is None:
                body += struct.pack("<QQII16x", off, header, 0, 0)
            else:
                body += struct.pack("<QQIIQQ", off, header, 1, 0, btree, lheap)
        body += b"\0" * (8 + per_node * 40 - len(body))
        leaves.append((out.put(bytes(body)), part[-1][0]))
    # a group node's key is the heap offset of the largest name to its left
    entries = [(struct.pack("<Q", leaves[i - 1][1] if i else 0), addr) for i, (addr, _) in enumerate(leaves)]
    last_key = struct.pack("<Q", leaves[-1][1] if leaves else 0)
    btree = _btree_nodes(out, 0, entries, last_key, _GROUP_NODE_K)
    messages = [(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))]
    messages += [(_ATTRIBUTE, _attribute_message(out, k, v)) for k, v in g.attrs.items()]
    return out.put(_object_header(messages)), btree, heap


def write(path, root: Group, threads: int = 1) -> None:
    """Write ``root`` (a ``Group`` built with ``create_group`` /
    ``create_dataset``) to ``path`` as a version-0 HDF5 file; the file is
    written beside ``path`` and renamed into place."""
    path = Path(path)
    tmp = path.with_name(path.name + ".part")
    try:
        threads = max(1, int(threads))
        with open(tmp, "wb") as fh, ThreadPoolExecutor(threads) as pool:
            out = _Out(fh, pool, threads)
            out.put(bytes(96))
            header, btree, heap = _write_group(out, root)
            eof = out.pos
            sb = SIGNATURE + bytes([0, 0, 0, 0, 0, _O, _O, 0]) + struct.pack("<HHI", _GROUP_LEAF_K, _GROUP_NODE_K, 0)
            sb += struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
            sb += struct.pack("<QQIIQQ", 0, header, 1, 0, btree, heap)
            fh.seek(0)
            fh.write(sb)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
