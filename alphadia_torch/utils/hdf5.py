"""A reader and a writer of the HDF5 subset that h5py writes at its defaults.

The card machine has no h5py, so the port reads and writes the HDF files
of the JAX package (spectra caches, libraries) and alphaRaw's raw files
itself, in numpy, ``zlib`` and ``struct``. The subset is that of
``h5py.File(path, "w")`` (``libver=("earliest", ...)``):

- superblock version 0 or 1 (a user block before it is found too);
  version-1 object headers with continuation blocks; groups as symbol
  tables (a version-1 B-tree of group nodes, a local heap, ``SNOD`` nodes);
- messages: dataspace (scalar and simple), datatype, fill value,
  attribute (versions 1-3), filter pipeline (versions 1 and 2), data layout
  version 3 (compact, contiguous, chunked with the version-1 B-tree chunk
  index: any depth, partial edge chunks stored at full chunk size);
- datatypes: little-endian fixed-point of 8-64 bits, IEEE float16/32/64,
  fixed-length strings (``S``, trailing NULs stripped as numpy strips
  them), variable-length strings (the global heap; read as ``str``) and
  enums (an 8-bit FALSE/TRUE enum, h5py's ``bool``, reads as ``bool``;
  other enums as their base integers);
- filters: deflate (1), shuffle (2), fletcher32 (3, verified) and LZF
  (32000, h5py's own), honouring a chunk's filter mask.

Anything else raises ``ValueError`` naming the structure: superblock
versions 2 and 3 (``libver="latest"``), version-2 object headers
(``OHDR``), link messages and dense (fractal-heap) storage, shared
messages, big-endian or non-IEEE types, compound and other classes, other
layouts and filters. So do truncated and corrupted files.

    with File(path) as f:                     # reading: h5py's small API
        f.attrs.get("format"); "peak_df" in f; f["peak_df"]["mz"][:]

    root = Group(attrs={"format": "..."})      # writing
    root.create_group("precursor_df").create_dataset("mz", data=array)
    write(path, root, threads=4)

The writer writes the same version-0 subset and nothing that depends on
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
_REFUSED_MESSAGES = {
    _LINK_INFO: "link info message (a new-style group: dense or compact link storage)",
    _LINK: "link message (a new-style group)",
    _EXTERNAL: "external data files message",
    _ATTRIBUTE_INFO: "attribute info message (dense attribute storage in a fractal heap)",
}
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
    if version not in (1, 2, 3):
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


def _parse_dataspace(b, src: _Source) -> tuple | None:
    """The shape; ``None`` for a null dataspace."""
    if len(b) < 8:
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
    return tuple(_uint(b, p + i * src.l, src.l) for i in range(rank))


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


class _Reader:
    def __init__(self, src: _Source, threads: int = 1):
        self.src, self.threads = src, threads
        self.heaps: dict[int, _Heap] = {}
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
        src = self.src
        head = src.read(addr, 16)
        if head[:4] == b"OHDR":
            raise ValueError(f"{src.name}: version-2 object header (OHDR) at address {addr}")
        if head[0] != 1:
            raise ValueError(f"{src.name}: object header version {head[0]} at address {addr}")
        blocks, seen, out = [(addr + 16, _uint(head, 8, 4))], {addr}, []
        while blocks:
            start, size = blocks.pop(0)
            body = src.read(start, size)
            p = 0
            while p + 8 <= size:
                mtype, msize, flags = struct.unpack_from("<HHB", body, p)
                if p + 8 + msize > size:
                    raise ValueError(f"{src.name}: object header message past its block at address {addr}")
                data = body[p + 8 : p + 8 + msize]
                p += 8 + msize
                if mtype == _CONTINUATION:
                    cont = _uint(data, 0, src.o)
                    if cont in seen:
                        raise ValueError(f"{src.name}: object header continuation loop at address {cont}")
                    seen.add(cont)
                    blocks.append((cont, _uint(data, src.o, src.l)))
                elif mtype in _REFUSED_MESSAGES:
                    raise ValueError(f"{src.name}: {_REFUSED_MESSAGES[mtype]} at address {addr}")
                elif flags & 0x02 and mtype != _NIL:
                    raise ValueError(f"{src.name}: shared object header message (type {mtype:#x}) at address {addr}")
                elif mtype != _NIL:
                    out.append((mtype, flags, data))
        return out

    def attributes(self, msgs) -> dict:
        out = {}
        for mtype, _, b in msgs:
            if mtype != _ATTRIBUTE:
                continue
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
                out[name] = None
                continue
            count = math.prod(shape)
            raw = bytes(b[p : p + count * dtype.size])
            if len(raw) != count * dtype.size:
                raise ValueError(f"{self.src.name}: truncated attribute {name!r}")
            value = self.convert(np.frombuffer(raw, dtype=dtype.storage).reshape(shape), dtype)
            out[name] = value[()] if shape == () else value
        return out

    def convert(self, raw: np.ndarray, dtype: _Type) -> np.ndarray:
        if dtype.kind == "bool":
            return raw.view(np.int8) != 0
        if dtype.kind == "vstr":
            return self.strings(raw)
        return raw

    def group_members(self, msgs) -> dict[str, int]:
        table = [b for t, _, b in msgs if t == _SYMBOL_TABLE]
        src = self.src
        btree, heap = _uint(table[0], 0, src.o), _uint(table[0], src.o, src.o)
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
        if version != 3:
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
        rank = b[2] - 1
        addr = _uint(b, 3, src.o)
        dims = [_uint(b, 3 + src.o + 4 * i, 4) for i in range(rank + 1)]
        if rank != len(self.shape) or dims[-1] != t.size or 0 in dims:
            raise ValueError(f"{src.name}: chunk shape {dims} does not fit dataset {self.name!r} {self.shape}")
        chunk = tuple(dims[:rank])
        chunk_bytes = math.prod(chunk) * t.size
        out = self._filled()
        if src.undef(addr) or not self.size:
            return out
        entries = []
        for key, child in self._reader.chunks(addr, rank + 1):
            size, mask = _uint(key, 0, 4), _uint(key, 4, 4)
            offset = tuple(_uint(key, 8 + 8 * i, 8) for i in range(rank))
            if any(o % c or o >= s for o, c, s in zip(offset, chunk, self.shape)):
                raise ValueError(f"{src.name}: chunk at {offset} outside dataset {self.name!r} {self.shape}")
            entries.append((offset, size, mask, child))
        pipeline, name = self._pipeline, self.name

        def one(entry):
            offset, size, mask, child = entry
            data = _unfilter(bytes(src.view(child, size)), pipeline, mask, chunk_bytes, f"{src.name}: {name!r}")
            arr = np.frombuffer(data, dtype=t.storage).reshape(chunk)
            region = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offset, chunk, self.shape))
            out[region] = arr[tuple(slice(0, r.stop - r.start) for r in region)]

        self._reader.map(one, entries)
        return out


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
        if any(t == _SYMBOL_TABLE for t, _, _ in msgs):
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
            root = _superblock(src)
            reader = _Reader(src, max(1, int(threads)))
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


def _superblock(src: _Source) -> int:
    """Find the superblock (at 0, 512, 1024, ...), set the source's base
    and sizes; return the root group's object header address."""
    at = 0
    while at + 8 <= src.size and src.buf[at : at + 8] != SIGNATURE:
        at = 512 if at == 0 else at * 2
    if at + 8 > src.size:
        raise ValueError(f"{src.name}: not an HDF5 file (no superblock signature)")
    head = src.read(at, 24)
    version = head[8]
    if version not in (0, 1):
        raise ValueError(f"{src.name}: superblock version {version} (written with libver later than 'earliest')")
    src.o, src.l = head[13], head[14]
    if src.o not in (2, 4, 8) or src.l not in (2, 4, 8):
        raise ValueError(f"{src.name}: superblock with {src.o}-byte offsets and {src.l}-byte lengths")
    p = at + 24 + (4 if version == 1 else 0)
    o = src.o
    fields = src.read(p, 4 * o + 2 * o + 24)
    base, eof = _uint(fields, 0, o), _uint(fields, 2 * o, o)
    if base != at:
        raise ValueError(f"{src.name}: superblock at {at} with base address {base}")
    src.base = base
    if eof > src.size:
        raise ValueError(f"{src.name}: truncated: end-of-file address {eof} past the file's {src.size} bytes")
    return _uint(fields, 4 * o + o, o)


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
