"""FASTA parsing. In-silico digestion (``digest_fasta``) comes with the
library-free prediction slice of the port."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np


def read_fasta(path: str | Path) -> dict:
    """A FASTA file as columns protein, gene, description, sequence."""
    records = []
    name, gene, desc, seq = None, "", "", []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    records.append((name, gene, desc, "".join(seq)))
                header = line[1:]
                parts = header.split("|")
                name = parts[1] if len(parts) >= 3 else header.split()[0]
                m = re.search(r"GN=(\S+)", header)
                gene = m.group(1) if m else name
                desc = header
                seq = []
            elif line:
                seq.append(line.upper())
    if name is not None:
        records.append((name, gene, desc, "".join(seq)))
    columns = ("protein", "gene", "description", "sequence")
    return {c: np.array([r[i] for r in records], dtype=object) for i, c in enumerate(columns)}
