"""Tab-separated column dicts, written as pandas' ``to_csv(sep="\\t",
index=False)`` writes them and read back for the values the port reads.

Writing: a header of the column names, then one line a row; a float32
value in its shortest float32 form (``str(np.float32)``, as pandas writes
a float32 column: no float64 digits are added), a float64 value as
``repr``, NaN and None as an empty field, booleans as ``True`` /
``False``; a field that holds a tab, a quote or a line break is quoted
with doubled quotes (``csv.QUOTE_MINIMAL``).

Reading: each column is int64 where every field is an integer (uint64
past int64's range), float64 where every field is a number or empty (empty
reads as NaN; parsed exactly), bool where every field is ``True`` /
``False``, else text (empty reads as None).
"""

from __future__ import annotations

import csv
import io
from pathlib import Path

import numpy as np


def _formatter(values: np.ndarray):
    kind = values.dtype.kind
    if kind == "f":
        cast = np.float32 if values.dtype == np.float32 else float
        fmt = str if values.dtype == np.float32 else repr
        return lambda v: "" if np.isnan(v) else fmt(cast(v))
    if kind in "iu":
        return lambda v: str(int(v))
    if kind == "b":
        return lambda v: "True" if v else "False"

    def text(v):
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return ""
        return str(v)

    return text


def to_tsv_text(frame: dict) -> str:
    columns = list(frame)
    arrays = [np.asarray(frame[c]) for c in columns]
    fmts = [_formatter(a) for a in arrays]
    buf = io.StringIO()
    writer = csv.writer(buf, delimiter="\t", lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
    writer.writerow(columns)
    n = len(arrays[0]) if arrays else 0
    for i in range(n):
        writer.writerow([f(a[i]) for f, a in zip(fmts, arrays)])
    return buf.getvalue()


def write_tsv(frame: dict, path: str | Path) -> None:
    Path(path).write_text(to_tsv_text(frame))


def _parse_column(fields: list[str]) -> np.ndarray:
    filled = [f for f in fields if f != ""]
    if filled and len(filled) == len(fields) and all(f in ("True", "False") for f in filled):
        return np.array([f == "True" for f in fields])
    try:
        ints = [int(f) for f in filled]
        if len(filled) == len(fields):
            fits = all(-(2**63) <= v < 2**63 for v in ints)
            return np.array(ints, dtype=np.int64 if fits else np.uint64)
    except (ValueError, OverflowError):
        pass
    try:
        return np.array([float(f) if f != "" else np.nan for f in fields], dtype=np.float64)
    except ValueError:
        return np.array([f if f != "" else None for f in fields], dtype=object)


def read_tsv(path: str | Path) -> dict:
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    if not rows:
        return {}
    header, body = rows[0], rows[1:]
    return {name: _parse_column([r[j] if j < len(r) else "" for r in body]) for j, name in enumerate(header)}
