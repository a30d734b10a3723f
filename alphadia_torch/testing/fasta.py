"""A seeded synthetic proteome as a FASTA file.

    write_fasta("db.fasta", n_proteins=20400, seed=0)

Residues are drawn with the composition of the human reference proteome
(UniProt UP000005640, in percent below, rounded) and protein lengths from a
log-normal with the proteome's median of about 415 residues; every protein
starts with Met. Headers follow UniProt's ``>sp|ACCESSION|NAME ... GN=GENE``.
20,400 proteins is the proteome's count of canonical entries.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

HUMAN_PROTEOME_PROTEINS = 20400
RESIDUE_PERCENT = {
    "L": 9.96, "S": 8.33, "E": 7.10, "A": 7.02, "G": 6.57, "P": 6.31, "V": 5.96, "K": 5.72, "R": 5.64, "T": 5.36,
    "Q": 4.77, "D": 4.74, "I": 4.33, "F": 3.65, "N": 3.58, "Y": 2.66, "H": 2.63, "C": 2.30, "M": 2.13, "W": 1.22,
}
LENGTH_MEDIAN = 415
LENGTH_SIGMA = 0.7
MIN_LENGTH = 30


def synthetic_proteome(n_proteins: int, seed: int = 0) -> list[tuple[str, str, str]]:
    """(accession, gene, sequence) of ``n_proteins`` proteins."""
    rng = np.random.default_rng(seed)
    residues = np.array(list(RESIDUE_PERCENT))
    p = np.array(list(RESIDUE_PERCENT.values()))
    lengths = np.maximum(rng.lognormal(np.log(LENGTH_MEDIAN), LENGTH_SIGMA, n_proteins).astype(np.int64), MIN_LENGTH)
    body = rng.choice(residues, size=int(lengths.sum()), p=p / p.sum())
    ends = np.cumsum(lengths)
    out = []
    for i, (a, b) in enumerate(zip(ends - lengths, ends)):
        out.append((f"S{i:05d}", f"GENE{i}", "M" + "".join(body[a + 1 : b])))
    return out


def write_fasta(path: str | Path, n_proteins: int, seed: int = 0) -> Path:
    path = Path(path)
    with open(path, "w") as f:
        for acc, gene, seq in synthetic_proteome(n_proteins, seed):
            f.write(f">sp|{acc}|{acc}_HUMAN Synthetic protein {acc} OS=Homo sapiens OX=9606 GN={gene}\n")
            for k in range(0, len(seq), 60):
                f.write(seq[k : k + 60] + "\n")
    return path
