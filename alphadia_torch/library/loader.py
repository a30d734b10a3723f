"""Spectral library loaders: long-format TSV/CSV transition lists (DIA-NN /
Spectronaut column names) into a hierarchical ``SpecLibBase``, the file's
masses taken as they are.

The JAX package's ``library/loader.py`` reads the table with pandas; this
loader reads it with the standard library's ``csv`` and gives the same
library: precursors in order of first appearance of (modified sequence,
charge), each cell's value converted as pandas would infer the column
(integers, floats, else text; pandas' missing-value markers as NaN), a
later row overwriting an earlier one in the same fragment cell.

``load_speclib_hdf`` reads the two HDF formats of ``SpecLibBase.save_hdf`` /
``SpecLibFlat.save_hdf`` and alphabase's layout (the frames under the root or
``library``), through the port's HDF5 reader.
"""

from __future__ import annotations

import csv
import logging
import re
from pathlib import Path

import numpy as np

from alphadia_torch.library.chem import UNIMOD_ID_TO_NAME as _UNIMOD_NAMES
from alphadia_torch.library.pipeline import ProcessingStep
from alphadia_torch.library.speclib import BASE_FORMAT, FLAT_FORMAT, SpecLibBase, SpecLibFlat, _df_from_hdf
from alphadia_torch.utils import hdf5

logger = logging.getLogger(__name__)

# column aliases in long-format transition lists
_PRECURSOR_ALIASES = {
    "modified_sequence": ["ModifiedPeptide", "ModifiedSequence", "ModifiedPeptideSequence", "modified_sequence", "FullUniModPeptideName"],
    "sequence": ["StrippedPeptide", "PeptideSequence", "Stripped.Sequence", "sequence", "naked_sequence"],
    "charge": ["PrecursorCharge", "Charge", "charge", "Precursor.Charge"],
    "precursor_mz": ["PrecursorMz", "Q1", "precursor_mz", "Precursor.Mz"],
    "rt": ["Tr_recalibrated", "iRT", "RT", "RetentionTime", "NormalizedRetentionTime", "rt", "irt"],
    "mobility": ["IonMobility", "PrecursorIonMobility", "mobility", "IM"],
    "proteins": ["ProteinGroups", "ProteinName", "UniprotID", "Protein.Ids", "proteins", "ProteinId"],
    "genes": ["Genes", "GeneName", "genes", "Gene.Names"],
}
_FRAGMENT_ALIASES = {
    "frag_mz": ["FragmentMz", "ProductMz", "Q3", "fragment_mz", "Product.Mz"],
    "frag_intensity": ["RelativeIntensity", "LibraryIntensity", "RelativeFragmentIntensity", "intensity", "Relative.Intensity"],
    "frag_type": ["FragmentType", "FragmentIonType", "frag_type", "Fragment.Type"],
    "frag_charge": ["FragmentCharge", "FragmentIonCharge", "frag_charge", "Fragment.Charge"],
    "frag_number": ["FragmentSeriesNumber", "FragmentNumber", "frag_number", "Fragment.Series.Number"],
}

# the cell texts pandas' read_csv takes as missing
_NA = {
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
    "NULL", "NaN", "None", "n/a", "nan", "null",
}
_INT = re.compile(r"^[+-]?\d+$")


def _typed_column(texts: list[str]) -> np.ndarray:
    """A column's cells as pandas' ``read_csv`` infers them: int64 when
    every cell is an integer, float64 when every present cell is a number
    (missing -> NaN), else text (missing -> NaN)."""
    missing = [t in _NA for t in texts]
    present = [t for t, m in zip(texts, missing) if not m]
    if present and not any(missing) and all(_INT.match(t) for t in present):
        return np.array([int(t) for t in texts], dtype=np.int64)
    try:
        if "_" not in "".join(present):
            return np.array([np.nan if m else float(t) for t, m in zip(texts, missing)], dtype=np.float64)
    except ValueError:
        pass
    return np.array([np.nan if m else t for t, m in zip(texts, missing)], dtype=object)


def _as_text(values: np.ndarray) -> list[str]:
    """``Series.astype(str)``: each value's ``str``."""
    if values.dtype.kind == "i":
        return [str(int(v)) for v in values]
    if values.dtype.kind == "f":
        return [str(float(v)) for v in values]
    return [str(v) for v in values]


def _read_table(path: str | Path, sep: str) -> dict[str, np.ndarray]:
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    if not rows:
        raise ValueError(f"empty transition list {path}")
    header, body = rows[0], rows[1:]
    width = len(header)
    texts = [[] for _ in range(width)]
    for r in body:
        r = (r + [""] * width)[:width]
        for j in range(width):
            texts[j].append(r[j])
    return {name: _typed_column(col) for name, col in zip(header, texts)}


def _find_col(df: dict, aliases: list[str]) -> str | None:
    return next((a for a in aliases if a in df), None)


def _parse_modified_sequence(modseq: str) -> tuple[str, str, str]:
    """'_AC(UniMod:4)DEK_' or 'AC[Carbamidomethyl (C)]DEK' -> (seq, mods, sites)."""
    s = str(modseq).strip("_")
    seq_chars: list[str] = []
    mods: list[str] = []
    sites: list[str] = []
    i = 0
    while i < len(s):
        c = s[i]
        if c in "([":
            close = {"(": ")", "[": "]"}[c]
            depth = 1
            j = i + 1
            while j < len(s) and depth:
                if s[j] == c:
                    depth += 1
                elif s[j] == close:
                    depth -= 1
                j += 1
            token = s[i + 1 : j - 1]
            low = token.lower().replace(" ", "")
            if low.startswith("unimod:"):
                uid = int(low.split(":")[1])
                name = _UNIMOD_NAMES.get(uid, f"UniMod:{uid}")
            else:
                name = token.split(" (")[0].split("(")[0].strip()
            pos = len(seq_chars)
            site_aa = seq_chars[-1] if seq_chars else "Any_N-term"
            mods.append(f"{name}@{site_aa if pos else 'Any_N-term'}")
            sites.append(str(pos if pos else 0))
            i = j
        else:
            seq_chars.append(c)
            i += 1
    return "".join(seq_chars), ";".join(mods), ";".join(sites)


def _groups_in_order(keys: list[str]) -> list[np.ndarray]:
    """Row indices of each key, keys in order of first appearance, rows in
    file order (``groupby(sort=False)``)."""
    groups: dict[str, list[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return [np.array(rows, dtype=np.int64) for rows in groups.values()]


def load_speclib_tsv(path: str | Path) -> SpecLibBase:
    sep = "," if str(path).lower().endswith(".csv") else "\t"
    df = _read_table(path, sep)

    cols = {k: _find_col(df, v) for k, v in _PRECURSOR_ALIASES.items()}
    fcols = {k: _find_col(df, v) for k, v in _FRAGMENT_ALIASES.items()}
    if cols["charge"] is None or fcols["frag_mz"] is None:
        raise ValueError(f"Unrecognized transition list format: {list(df)[:20]}")

    modseq_col = cols["modified_sequence"] or cols["sequence"]
    modseq_text = _as_text(df[modseq_col])
    keys = [f"{m}/{c}" for m, c in zip(modseq_text, _as_text(df[cols["charge"]]))]

    n_rows = len(keys)
    ftype = [t[0].lower() for t in _as_text(df[fcols["frag_type"]])] if fcols["frag_type"] else ["y"] * n_rows
    fcharge = df[fcols["frag_charge"]].astype(int) if fcols["frag_charge"] else np.ones(n_rows, np.int64)
    fnumber = df[fcols["frag_number"]].astype(int) if fcols["frag_number"] else np.ones(n_rows, np.int64)
    fmz = df[fcols["frag_mz"]]
    finten = df[fcols["frag_intensity"]] if fcols["frag_intensity"] else None

    max_fz = int(np.clip(fcharge.max() if fcols["frag_charge"] else 1, 1, 2))
    types = [t for t in sorted(set(ftype)) if t in "abcxyz"] or ["b", "y"]
    col_names = [f"{t}_z{z}" for t in types for z in range(1, max_fz + 1)]
    col_of = {c: j for j, c in enumerate(col_names)}

    groups = _groups_in_order(keys)
    text = {k: _as_text(df[cols[k]]) for k in ("sequence", "proteins", "genes") if cols[k]}
    seqs = [text["sequence"][g[0]] if cols["sequence"] else _parse_modified_sequence(modseq_text[g[0]])[0] for g in groups]
    total_sites = sum(max(len(s) - 1, 1) for s in seqs)

    mz_mat = np.zeros((total_sites, len(col_names)), dtype=np.float32)
    int_mat = np.zeros((total_sites, len(col_names)), dtype=np.float32)
    prec = {k: [] for k in ("sequence", "mods", "mod_sites", "charge", "precursor_mz", "rt", "mobility", "proteins", "genes", "frag_start_idx", "frag_stop_idx", "nAA")}
    cursor = 0
    for g, seq in zip(groups, seqs):
        first = g[0]
        mods, sites = ("", "")
        if cols["modified_sequence"]:
            _, mods, sites = _parse_modified_sequence(modseq_text[first])
        naa = len(seq)
        n_sites = max(naa - 1, 1)
        prec["sequence"].append(seq)
        prec["mods"].append(mods)
        prec["mod_sites"].append(sites)
        prec["charge"].append(df[cols["charge"]][first])
        for k in ("precursor_mz", "rt", "mobility"):
            prec[k].append(df[cols[k]][first] if cols[k] else 0.0)
        for k in ("proteins", "genes"):
            prec[k].append(text[k][first] if cols[k] else "")
        prec["frag_start_idx"].append(cursor)
        prec["frag_stop_idx"].append(cursor + n_sites)
        prec["nAA"].append(naa)
        for r in g:
            t, z, num = ftype[r], int(fcharge[r]), int(fnumber[r])
            j = col_of.get(f"{t}_z{z}")
            if j is None:
                continue
            pos = num - 1 if t in "abc" else naa - 1 - num
            if not (0 <= pos < n_sites):
                continue
            mz_mat[cursor + pos, j] = fmz[r]
            int_mat[cursor + pos, j] = finten[r] if finten is not None else 1.0
        cursor += n_sites

    dtypes = {"charge": np.uint8, "precursor_mz": np.float32, "rt": np.float32, "mobility": np.float32,
              "frag_start_idx": np.uint32, "frag_stop_idx": np.uint32, "nAA": np.uint8}
    precursor_df = {k: np.array(v, dtype=dtypes.get(k, object)) for k, v in prec.items()}
    logger.info("Loaded %d precursors from %s", len(groups), path)
    return SpecLibBase(precursor_df, mz_mat, int_mat, col_names)


def load_speclib_hdf(path: str | Path, thread_count: int = 1):
    """Our HDF formats; else alphabase's frames under the root or ``library``."""
    with hdf5.File(path, threads=thread_count) as f:
        fmt = f.attrs.get("format", "")
        if fmt == BASE_FORMAT:
            return SpecLibBase.load_hdf(path, thread_count)
        if fmt == FLAT_FORMAT:
            return SpecLibFlat.load_hdf(path, thread_count)
        root = f["library"] if "library" in f else f
        if "precursor_df" in root:
            prec = _hdf_group_to_df(root["precursor_df"])
            frames = [_hdf_group_to_df(root[k]) if k in root else None for k in ("fragment_mz_df", "fragment_intensity_df")]
            return SpecLibBase.from_frames(prec, *frames)
    raise ValueError(f"Unrecognized speclib HDF layout in {path}")


def _hdf_group_to_df(group) -> dict:
    """A frame of ``_df_to_hdf``, else every 1-D dataset of the group in
    name order (variable-length strings as ``str``); sub-groups, other
    shapes and datasets outside the reader's subset are skipped."""
    if "columns" in group.attrs:
        return _df_from_hdf(group)
    data = {}
    for k in group:
        node = group[k]
        if not isinstance(node, hdf5.Dataset):
            continue
        try:
            vals = node[()]
        except ValueError:
            continue
        if getattr(vals, "ndim", 1) == 1:
            if vals.dtype.kind == "S":
                vals = vals.astype(str).astype(object)
            data[k] = vals
    return data


class DynamicLoader(ProcessingStep):
    """The library loader by file extension."""

    def validate(self, input_) -> bool:
        return isinstance(input_, (str, Path)) and Path(input_).exists()

    def forward(self, path):
        suffix = Path(path).suffix.lower()
        if suffix in (".hdf", ".hdf5", ".h5"):
            return load_speclib_hdf(path)
        if suffix in (".tsv", ".csv", ".txt"):
            return load_speclib_tsv(path)
        raise ValueError(f"Unsupported library format {suffix}")
