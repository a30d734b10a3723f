"""A minimal Parquet writer and reader for column dicts (the card machine
has no pyarrow).

What it writes: one row group, every column a single uncompressed v1 data
page in PLAIN encoding, marked OPTIONAL with its definition levels (so that
a NaN of a float column is stored as a null, as pandas writes it through
pyarrow), the footer in Thrift's compact protocol. Column types:

===========================  ============  ==========================
numpy dtype                  physical      logical (converted) type
===========================  ============  ==========================
bool                         BOOLEAN       -
int8 / int16 / int32         INT32         INT(8|16, signed) / -
uint8 / uint16 / uint32      INT32         INT(8|16|32, unsigned)
int64 / uint64               INT64         - / INT(64, unsigned)
float32 / float64            FLOAT/DOUBLE  -
str (``U`` or object)        BYTE_ARRAY    STRING (UTF8)
===========================  ============  ==========================

so pyarrow reads every column back with its dtype. The reader reads these
files and the flat files that pyarrow writes with its defaults (Snappy,
dictionary pages) or without compression (several data pages a column,
nulls). A null reads as NaN in a float column and as None in a text
column.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_MAGIC = b"PAR1"

# parquet.thrift enums
BOOLEAN, INT32, INT64, FLOAT, DOUBLE, BYTE_ARRAY = 0, 1, 2, 4, 5, 6
REQUIRED, OPTIONAL = 0, 1
UTF8, UINT_8, UINT_16, UINT_32, UINT_64, INT_8, INT_16, INT_32, INT_64 = 0, 11, 12, 13, 14, 15, 16, 17, 18
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
UNCOMPRESSED, SNAPPY = 0, 1
DATA_PAGE, DICTIONARY_PAGE = 0, 2

# thrift compact protocol type ids
_T_TRUE, _T_FALSE, _T_BYTE, _T_I16, _T_I32, _T_I64, _T_DOUBLE, _T_BINARY, _T_LIST, _T_SET, _T_MAP, _T_STRUCT = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
)


# ---------------------------------------------------------------------------
# thrift compact protocol
# ---------------------------------------------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


class _Struct:
    """A thrift struct to encode: ``fields`` maps field id -> (type, value);
    ``_T_I32`` values are ints, ``_T_BINARY`` bytes or str, ``_T_STRUCT``
    ``_Struct``, ``_T_LIST`` (element type, [values]), ``_T_TRUE`` a bool."""

    def __init__(self, **fields):
        self.fields = {int(k[1:]): v for k, v in fields.items() if v is not None}

    def encode(self) -> bytes:
        out = bytearray()
        last = 0
        for fid in sorted(self.fields):
            ttype, value = self.fields[fid]
            if ttype == _T_TRUE:
                ttype = _T_TRUE if value else _T_FALSE
            delta = fid - last
            if 0 < delta <= 15:
                out.append((delta << 4) | ttype)
            else:
                out.append(ttype)
                out += _varint(_zigzag(fid))
            last = fid
            if ttype not in (_T_TRUE, _T_FALSE):
                out += _encode_value(ttype, value)
        out.append(0)
        return bytes(out)


def _encode_value(ttype: int, value) -> bytes:
    if ttype == _T_BYTE:
        return struct.pack("<b", value)
    if ttype in (_T_I16, _T_I32, _T_I64):
        return _varint(_zigzag(int(value)))
    if ttype == _T_BINARY:
        raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        return _varint(len(raw)) + raw
    if ttype == _T_STRUCT:
        return value.encode()
    if ttype == _T_LIST:
        etype, items = value
        head = bytes([(len(items) << 4) | etype]) if len(items) < 15 else bytes([0xF0 | etype]) + _varint(len(items))
        return head + b"".join(_encode_value(etype, v) for v in items)
    raise ValueError(f"thrift type {ttype} is not written")


class _Reader:
    """Decodes thrift compact structs into {field id: value} dicts."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        shift = result = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def value(self, ttype: int):
        if ttype == _T_TRUE:
            return True
        if ttype == _T_FALSE:
            return False
        if ttype == _T_BYTE:
            self.pos += 1
            return struct.unpack_from("<b", self.buf, self.pos - 1)[0]
        if ttype in (_T_I16, _T_I32, _T_I64):
            return self.zigzag()
        if ttype == _T_DOUBLE:
            self.pos += 8
            return struct.unpack_from("<d", self.buf, self.pos - 8)[0]
        if ttype == _T_BINARY:
            n = self.varint()
            self.pos += n
            return bytes(self.buf[self.pos - n : self.pos])
        if ttype in (_T_LIST, _T_SET):
            head = self.buf[self.pos]
            self.pos += 1
            size, etype = head >> 4, head & 0x0F
            if size == 15:
                size = self.varint()
            if etype in (_T_TRUE, _T_FALSE):
                out = [self.buf[self.pos + i] == 1 for i in range(size)]
                self.pos += size
                return out
            return [self.value(etype) for _ in range(size)]
        if ttype == _T_MAP:
            size = self.varint()
            if size == 0:
                return {}
            kv = self.buf[self.pos]
            self.pos += 1
            return {self.value(kv >> 4): self.value(kv & 0x0F) for _ in range(size)}
        if ttype == _T_STRUCT:
            return self.struct()
        raise ValueError(f"unknown thrift compact type {ttype}")

    def struct(self) -> dict:
        out = {}
        last = 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == 0:
                return out
            ttype = head & 0x0F
            delta = head >> 4
            fid = last + delta if delta else self.zigzag()
            out[fid] = self.value(ttype)
            last = fid


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------
def _column_type(values: np.ndarray):
    """(physical type, converted type, logical type, plain-encoded values of
    the present cells, null mask) of one column."""
    kind, size = values.dtype.kind, values.dtype.itemsize
    null = np.zeros(len(values), bool)
    if kind == "b":
        return BOOLEAN, None, None, np.packbits(values.astype(bool), bitorder="little").tobytes(), null
    if kind in "iu":
        signed = kind == "i"
        bits = size * 8
        logical = None
        converted = None
        if not (signed and bits in (32, 64)):
            converted = {(8, True): INT_8, (16, True): INT_16, (8, False): UINT_8, (16, False): UINT_16,
                         (32, False): UINT_32, (64, False): UINT_64}[(bits, signed)]
            logical = _Struct(f10=(_T_STRUCT, _Struct(f1=(_T_BYTE, bits), f2=(_T_TRUE, signed))))
        if bits == 64:
            return INT64, converted, logical, values.astype(np.uint64 if not signed else np.int64).view("<i8").tobytes(), null
        return INT32, converted, logical, values.astype(np.int64).astype("<u4" if not signed else "<i4").view("<i4").tobytes(), null
    if kind == "f":
        null = np.isnan(values)
        present = values[~null]
        if size == 4:
            return FLOAT, None, None, present.astype("<f4").tobytes(), null
        return DOUBLE, None, None, present.astype("<f8").tobytes(), null
    if kind in "UO":
        # None, and NaN as pandas fills a text column, are nulls
        null = np.array([v is None or (isinstance(v, float) and v != v) for v in values], bool)
        parts = []
        for v in values[~null]:
            if not isinstance(v, str):
                raise TypeError(f"a text column holds a {type(v).__name__}")
            raw = v.encode("utf-8")
            parts.append(struct.pack("<i", len(raw)) + raw)
        return BYTE_ARRAY, UTF8, _Struct(f1=(_T_STRUCT, _Struct())), b"".join(parts), null
    raise TypeError(f"no parquet column type for dtype {values.dtype}")


def _definition_levels(null: np.ndarray) -> bytes:
    """The levels (1 present, 0 null) in the RLE/bit-packed hybrid, behind
    their 4-byte length: one RLE run where no cell is null, else bit-packed
    groups of eight."""
    n = len(null)
    if not null.any():
        body = _varint(n << 1) + b"\x01" if n else b""
    else:
        groups = (n + 7) // 8
        levels = np.zeros(groups * 8, bool)
        levels[:n] = ~null
        body = _varint((groups << 1) | 1) + np.packbits(levels, bitorder="little").tobytes()
    return struct.pack("<i", len(body)) + body


def write_parquet(frame: dict, path: str | Path) -> None:
    """Write a column dict (every column a 1-D array of one length)."""
    names = [str(k) for k in frame]
    columns = [np.asarray(v) for v in frame.values()]
    n = len(columns[0]) if columns else 0
    if any(len(c) != n for c in columns):
        raise ValueError("columns of different lengths")
    out = bytearray(_MAGIC)
    schema = [_Struct(f4=(_T_BINARY, "schema"), f5=(_T_I32, len(names)))]
    chunks = []
    total = 0
    for name, values in zip(names, columns):
        physical, converted, logical, data, null = _column_type(values)
        page = _definition_levels(null) + data
        header = _Struct(
            f1=(_T_I32, DATA_PAGE),
            f2=(_T_I32, len(page)),
            f3=(_T_I32, len(page)),
            f5=(_T_STRUCT, _Struct(f1=(_T_I32, n), f2=(_T_I32, PLAIN), f3=(_T_I32, RLE), f4=(_T_I32, RLE))),
        ).encode()
        offset = len(out)
        out += header + page
        size = len(header) + len(page)
        total += size
        schema.append(
            _Struct(
                f1=(_T_I32, physical),
                f3=(_T_I32, OPTIONAL),
                f4=(_T_BINARY, name),
                f6=(_T_I32, converted) if converted is not None else None,
                f10=(_T_STRUCT, logical) if logical is not None else None,
            )
        )
        meta = _Struct(
            f1=(_T_I32, physical),
            f2=(_T_LIST, (_T_I32, [PLAIN, RLE])),
            f3=(_T_LIST, (_T_BINARY, [name])),
            f4=(_T_I32, UNCOMPRESSED),
            f5=(_T_I64, n),
            f6=(_T_I64, size),
            f7=(_T_I64, size),
            f9=(_T_I64, offset),
        )
        chunks.append(_Struct(f2=(_T_I64, offset), f3=(_T_STRUCT, meta)))
    row_group = _Struct(
        f1=(_T_LIST, (_T_STRUCT, chunks)),
        f2=(_T_I64, total),
        f3=(_T_I64, n),
        f5=(_T_I64, 4),
        f6=(_T_I64, total),
        f7=(_T_I16, 0),
    )
    footer = _Struct(
        f1=(_T_I32, 1),
        f2=(_T_LIST, (_T_STRUCT, schema)),
        f3=(_T_I64, n),
        f4=(_T_LIST, (_T_STRUCT, [row_group])),
        f6=(_T_BINARY, "alphadia_torch parquet writer"),
    ).encode()
    out += footer + struct.pack("<i", len(footer)) + _MAGIC
    Path(path).write_bytes(bytes(out))


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------
def _hybrid(buf: bytes, pos: int, end: int, bit_width: int, count: int) -> np.ndarray:
    """``count`` values of the RLE/bit-packed hybrid in ``buf[pos:end]``."""
    out = np.zeros(count, np.int32)
    filled = 0
    r = _Reader(buf, pos)
    width_bytes = (bit_width + 7) // 8
    if bit_width == 0:
        return out
    while filled < count and r.pos < end:
        head = r.varint()
        if head & 1:
            n = (head >> 1) * 8
            raw = np.frombuffer(buf, np.uint8, n * bit_width // 8, r.pos)
            r.pos += n * bit_width // 8
            bits = np.unpackbits(raw, bitorder="little").reshape(-1, bit_width)
            vals = (bits.astype(np.int32) << np.arange(bit_width, dtype=np.int32)).sum(1)
        else:
            n = head >> 1
            vals = np.full(n, int.from_bytes(buf[r.pos : r.pos + width_bytes], "little"), np.int32)
            r.pos += width_bytes
        take = min(n, count - filled)
        out[filled : filled + take] = vals[:take]
        filled += take
    return out


def _plain(buf: bytes, pos: int, physical: int, n: int):
    """``n`` PLAIN values from ``buf[pos:]``: (values, bytes read)."""
    if physical == BOOLEAN:
        nbytes = (n + 7) // 8
        bits = np.unpackbits(np.frombuffer(buf, np.uint8, nbytes, pos), bitorder="little")[:n]
        return bits.astype(bool), nbytes
    if physical == BYTE_ARRAY:
        out, p = [], pos
        for _ in range(n):
            (length,) = struct.unpack_from("<i", buf, p)
            out.append(buf[p + 4 : p + 4 + length].decode("utf-8"))
            p += 4 + length
        return np.array(out, dtype=object), p - pos
    dtype = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}.get(physical)
    if dtype is None:
        raise ValueError(f"parquet physical type {physical} is not read")
    values = np.frombuffer(buf, dtype, n, pos)
    return values, values.nbytes


def _numpy_dtype(element: dict):
    physical = element.get(1)
    logical = element.get(10) or {}
    converted = element.get(6)
    if physical == BOOLEAN:
        return np.dtype(bool)
    if physical == BYTE_ARRAY or 11 in logical:  # text, or pyarrow's all-null type
        return np.dtype(object)
    if physical == FLOAT:
        return np.dtype(np.float32)
    if physical == DOUBLE:
        return np.dtype(np.float64)
    if 10 in logical:
        bits, signed = logical[10][1], logical[10][2]
        return np.dtype(f"{'i' if signed else 'u'}{bits // 8}")
    by_converted = {INT_8: "i1", INT_16: "i2", INT_32: "i4", INT_64: "i8", UINT_8: "u1", UINT_16: "u2", UINT_32: "u4", UINT_64: "u8"}
    if converted in by_converted:
        return np.dtype(by_converted[converted])
    return np.dtype(np.int32 if physical == INT32 else np.int64)


def _snappy(raw: bytes) -> bytes:
    """A raw Snappy block decompressed (the codec pyarrow writes by
    default): a varint length, then literals and back-references."""
    r = _Reader(raw, 0)
    out = bytearray()
    size = r.varint()
    pos = r.pos
    while pos < len(raw):
        tag = raw[pos]
        kind = tag & 3
        pos += 1
        if kind == 0:
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                length = int.from_bytes(raw[pos : pos + extra], "little") + 1
                pos += extra
            out += raw[pos : pos + length]
            pos += length
            continue
        if kind == 1:
            length = ((tag >> 2) & 7) + 4
            offset = ((tag >> 5) << 8) | raw[pos]
            pos += 1
        else:
            width = 2 if kind == 2 else 4
            length = (tag >> 2) + 1
            offset = int.from_bytes(raw[pos : pos + width], "little")
            pos += width
        start = len(out) - offset
        if offset >= length:
            out += out[start : start + length]
        else:  # an overlapping copy repeats the last ``offset`` bytes
            for i in range(length):
                out.append(out[start + i])
    if len(out) != size:
        raise ValueError("corrupt snappy block")
    return bytes(out)


def read_parquet(path: str | Path) -> dict:
    """A flat Parquet file (no nesting; uncompressed or Snappy; PLAIN or
    dictionary-encoded v1 data pages, as this writer and pyarrow's defaults
    write them) as a column dict with the dtypes of the table above."""
    buf = Path(path).read_bytes()
    if buf[:4] != _MAGIC or buf[-4:] != _MAGIC:
        raise ValueError(f"{path} is not a parquet file")
    (footer_len,) = struct.unpack_from("<i", buf, len(buf) - 8)
    meta = _Reader(buf, len(buf) - 8 - footer_len).struct()
    schema = meta[2]
    leaves = schema[1:]
    if any(5 in e for e in leaves):
        raise ValueError(f"{path}: nested columns are not read")
    parts: dict[str, list] = {e[4].decode(): [] for e in leaves}
    for rg in meta.get(4, []):
        for element, chunk in zip(leaves, rg[1]):
            cm = chunk[3]
            codec = cm.get(4, UNCOMPRESSED)
            if codec not in (UNCOMPRESSED, SNAPPY):
                raise ValueError(f"{path}: compression codec {codec} (only none and Snappy) is not read")
            physical = cm[1]
            optional = element.get(3, REQUIRED) == OPTIONAL
            n_total = cm[5]
            pos = cm.get(11) or cm[9]
            read = 0
            dictionary = None
            while read < n_total:
                r = _Reader(buf, pos)
                header = r.struct()
                page = buf[r.pos : r.pos + header[3]]
                pos = r.pos + header[3]
                if codec == SNAPPY:
                    page = _snappy(page)
                if header[1] == DICTIONARY_PAGE:
                    dictionary, _ = _plain(page, 0, physical, header[7][1])
                    continue
                if header[1] != DATA_PAGE:
                    raise ValueError(f"{path}: page type {header[1]} (only v1 data and dictionary pages) is not read")
                dph = header[5]
                n = dph[1]
                p = 0
                present = np.ones(n, bool)
                if optional:
                    (length,) = struct.unpack_from("<i", page, p)
                    present = _hybrid(page, p + 4, p + 4 + length, 1, n) == 1
                    p += 4 + length
                n_present = int(present.sum())
                if dph[2] == PLAIN:
                    values, _ = _plain(page, p, physical, n_present)
                elif dph[2] in (PLAIN_DICTIONARY, RLE_DICTIONARY) and dictionary is not None:
                    values = dictionary[_hybrid(page, p + 1, len(page), page[p], n_present)]
                else:
                    raise ValueError(f"{path}: encoding {dph[2]} (only PLAIN and dictionary) is not read")
                parts[element[4].decode()].append((values, present))
                read += n
    out = {}
    for element in leaves:
        name = element[4].decode()
        dtype = _numpy_dtype(element)
        pieces = []
        for values, present in parts[name]:
            if present.all() and dtype.kind != "O":
                pieces.append(values.view(dtype) if dtype.kind in "iu" and dtype.itemsize == values.itemsize else values.astype(dtype))
                continue
            if dtype.kind == "f":
                col = np.full(len(present), np.nan, dtype)
            elif dtype.kind == "O":
                col = np.full(len(present), None, dtype=object)
            else:
                raise ValueError(f"{path}: column {name} of dtype {dtype} holds nulls")
            col[present] = values
            pieces.append(col)
        out[name] = np.concatenate(pieces) if pieces else np.zeros(0, dtype)
    return out
