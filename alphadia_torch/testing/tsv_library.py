"""A flat library as a long-format transition list (DIA-NN column names),
one row per fragment, for ``library.loader.load_speclib_tsv``.

The loader puts each fragment into the cell of its (type, charge, series
number) and drops a number that does not fit the sequence, so the writer
refuses a library whose fragments share a cell or lie outside their
sequence: the generator's ``from_sequence`` worlds, whose fragments are real
b/y ions, are what it writes. Floats are written as the
shortest decimal of their float64 value, so that the loader reads every
float32 back exactly.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

COLUMNS = (
    "ModifiedPeptide", "PrecursorCharge", "PrecursorMz", "Tr_recalibrated", "IonMobility", "ProteinGroups", "Genes",
    "FragmentMz", "RelativeIntensity", "FragmentType", "FragmentCharge", "FragmentSeriesNumber",
)


def assign_proteins(n: int, seed: int, per_protein: int = 4, shared: float = 0.1) -> tuple[np.ndarray, np.ndarray]:
    """(proteins, genes) of ``n`` peptides as a digest gives them: the
    peptides dealt at random to ``ceil(n / per_protein)`` proteins, and a
    ``shared`` share of them also to a second protein (``"P00001;P00042"``,
    the names sorted), so that protein grouping and parsimony have work to
    do. Made from ``seed``."""
    rng = np.random.default_rng(seed)
    n_prot = max(-(-n // per_protein), 2)
    owner = rng.permutation(n) % n_prot
    second = (owner + 1 + rng.integers(0, n_prot - 1, n)) % n_prot
    is_shared = rng.random(n) < shared
    proteins, genes = [], []
    for a, b, sh in zip(owner.tolist(), second.tolist(), is_shared.tolist()):
        ids = sorted({a, b}) if sh else [a]
        proteins.append(";".join(f"P{i:05d}" for i in ids))
        genes.append(";".join(f"G{i:05d}" for i in ids))
    return np.array(proteins, dtype=object), np.array(genes, dtype=object)


def _num(v) -> str:
    return repr(float(v))


def write_transition_list(path: str | Path, precursor: dict, fragment: dict) -> int:
    """Write the precursors of an unmodified flat library (``sequence``,
    ``charge``, ``mz_library``, ``rt_library``, ``mobility_library``,
    ``proteins``, ``genes``, ``flat_frag_start_idx`` / ``stop``) and their
    fragments; returns the precursors written."""
    if any(m for m in precursor.get("mods", [])):
        raise ValueError("write_transition_list writes unmodified sequences only")
    n = len(precursor["sequence"])
    ftype, fcharge, fnumber = fragment["type"], fragment["charge"], fragment["number"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(COLUMNS)
        for i in range(n):
            seq = str(precursor["sequence"][i])
            head = [
                f"_{seq}_", int(precursor["charge"][i]), _num(precursor["mz_library"][i]),
                _num(precursor["rt_library"][i]), _num(precursor["mobility_library"][i]),
                precursor["proteins"][i] if "proteins" in precursor else "",
                precursor["genes"][i] if "genes" in precursor else "",
            ]
            cells = set()
            for j in range(int(precursor["flat_frag_start_idx"][i]), int(precursor["flat_frag_stop_idx"][i])):
                cell = (chr(int(ftype[j])), int(fcharge[j]), int(fnumber[j]))
                if cell in cells or not 1 <= cell[2] <= len(seq) - 1:
                    raise ValueError(f"precursor {i} ({seq}): fragment {cell} repeats a cell or lies outside the sequence")
                cells.add(cell)
                w.writerow(head + [_num(fragment["mz_library"][j]), _num(fragment["intensity"][j]), *cell])
    return n

