"""FASTA parsing and in-silico digestion into a precursor library.

    lib = digest_fasta(["db.fasta"])  # a SpecLibBase: one row a precursor

Cleaves each protein at the enzyme's sites with missed cleavages, applies
fixed modifications, enumerates variable ones (up to ``max_var_mod_num``),
keeps the charges and m/z in range and annotates each peptide with its
proteins and genes. The JAX package's ``library/digest.py`` with column
dicts for its pandas frames: the same rows in the same order.
"""

from __future__ import annotations

import itertools
import re
from pathlib import Path

import numpy as np

from alphadia_torch.library import chem
from alphadia_torch.library.speclib import SpecLibBase

ENZYME_RULES = {
    # cut after these residues, unless followed by the blocked residue
    "trypsin": (set("KR"), set("P")),
    "trypsin/p": (set("KR"), set()),
    "lys-c": (set("K"), set("P")),
    "arg-c": (set("R"), set("P")),
    "chymotrypsin": (set("FWYL"), set("P")),
}

_PRECURSOR_COLUMNS = ("sequence", "mods", "mod_sites", "charge", "precursor_mz", "proteins", "genes")


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


def digest_sequence(sequence: str, enzyme: str = "trypsin", missed_cleavages: int = 1) -> list[str]:
    """Cleave one protein sequence into peptides."""
    cut_after, blocked_by = ENZYME_RULES[enzyme.lower()]
    sites = [0]
    for i, aa in enumerate(sequence[:-1]):
        if aa in cut_after and sequence[i + 1] not in blocked_by:
            sites.append(i + 1)
    sites.append(len(sequence))
    peptides = []
    for i in range(len(sites) - 1):
        for j in range(i + 1, min(i + 2 + missed_cleavages, len(sites))):
            peptides.append(sequence[sites[i] : sites[j]])
    return peptides


def _variable_mod_combos(
    sequence: str,
    is_protein_nterm: bool,
    var_mods: list[tuple[str, str]],
    max_var: int,
    fixed_sites: frozenset[int] = frozenset(),
) -> list[tuple[str, str]]:
    """(mods, mod_sites) strings for up to ``max_var`` variable mods. A site
    that a fixed modification occupies takes no variable one (a fixed N-term
    label and a variable N-term acetyl cannot both sit on residue 1)."""
    candidates: list[tuple[str, int]] = []  # (full mod name, site)
    for mod, site_spec in var_mods:
        if site_spec == "Protein_N-term":
            if is_protein_nterm and 0 not in fixed_sites:
                candidates.append((f"{mod}@Protein_N-term", 0))
        elif site_spec == "Any_N-term":
            if 0 not in fixed_sites:
                candidates.append((f"{mod}@Any_N-term", 0))
        else:
            for i, aa in enumerate(sequence):
                if aa == site_spec and (i + 1) not in fixed_sites:
                    candidates.append((f"{mod}@{site_spec}", i + 1))
    combos = [("", "")]
    for k in range(1, max_var + 1):
        for combo in itertools.combinations(candidates, k):
            sites = [c[1] for c in combo]
            if len(set(sites)) < len(sites):
                continue
            order = np.argsort(sites)
            combos.append((";".join(combo[i][0] for i in order), ";".join(str(combo[i][1]) for i in order)))
    return combos


def _apply_fixed_mods(sequence: str, fixed_mods: list[tuple[str, str]]) -> tuple[str, str]:
    names, sites = [], []
    for mod, site_aa in fixed_mods:
        if site_aa == "Any_N-term":  # e.g. a fixed TMT / mTRAQ label
            names.append(f"{mod}@{site_aa}")
            sites.append("0")
            continue
        for i, aa in enumerate(sequence):
            if aa == site_aa:
                names.append(f"{mod}@{site_aa}")
                sites.append(str(i + 1))
    return ";".join(names), ";".join(sites)


def _merge_mods(a: tuple[str, str], b: tuple[str, str]) -> tuple[str, str]:
    names = [x for x in (a[0], b[0]) if x]
    sites = [x for x in (a[1], b[1]) if x]
    return ";".join(names), ";".join(sites)


def digest_fasta(
    fasta_paths: list[str],
    enzyme: str = "trypsin",
    missed_cleavages: int = 1,
    fixed_modifications: str = "Carbamidomethyl@C",
    variable_modifications: str = "Oxidation@M;Acetyl@Protein_N-term",
    max_var_mod_num: int = 2,
    precursor_len: tuple[int, int] = (7, 35),
    precursor_charge: tuple[int, int] = (2, 4),
    precursor_mz: tuple[float, float] = (400.0, 1200.0),
) -> SpecLibBase:
    """Digest FASTA file(s) into a SpecLibBase with precursor m/z computed."""
    fixed = chem.parse_mod_spec(fixed_modifications)
    variable = chem.parse_mod_spec(variable_modifications)

    # peptide -> [protein set, gene set, any protein N-terminus], in the
    # order peptides are first met
    pep_map: dict[str, list] = {}
    for path in fasta_paths:
        proteins = read_fasta(path)
        for prot, gene_name, seq in zip(proteins["protein"], proteins["gene"], proteins["sequence"]):
            if not seq:
                continue
            for pep in digest_sequence(seq, enzyme, missed_cleavages):
                if not (precursor_len[0] <= len(pep) <= precursor_len[1]):
                    continue
                if any(aa not in chem.AA_MASS for aa in pep):
                    continue
                entry = pep_map.setdefault(pep, [set(), set(), False])
                entry[0].add(prot)
                entry[1].add(gene_name)
                if seq.startswith(pep) or seq[1:].startswith(pep):  # with and without the initiator Met
                    entry[2] = True

    rows = []
    for pep, (prots, genes, is_nterm) in pep_map.items():
        fixed_applied = _apply_fixed_mods(pep, fixed)
        fixed_sites = frozenset(int(s) for s in fixed_applied[1].split(";") if s != "")
        protein_col, gene_col = ";".join(sorted(prots)), ";".join(sorted(genes))
        for mods, sites in _variable_mod_combos(pep, is_nterm, variable, max_var_mod_num, fixed_sites):
            all_mods, all_sites = _merge_mods(fixed_applied, (mods, sites))
            mass = chem.residue_masses(pep, all_mods, all_sites).sum() + chem.MASS_H2O
            for z in range(precursor_charge[0], precursor_charge[1] + 1):
                mz = mass / z + chem.MASS_PROTON
                if precursor_mz[0] <= mz <= precursor_mz[1]:
                    rows.append((pep, all_mods, all_sites, z, np.float32(mz), protein_col, gene_col))

    df = {c: np.array([r[i] for r in rows], dtype=object) for i, c in enumerate(_PRECURSOR_COLUMNS)}
    df["charge"] = df["charge"].astype(np.uint8)
    df["precursor_mz"] = df["precursor_mz"].astype(np.float32)
    df["decoy"] = np.zeros(len(rows), np.uint8)
    df["channel"] = np.zeros(len(rows), np.uint32)
    return SpecLibBase(df)
