"""Peptide chemistry: masses, fragment series, isotope envelopes.

The JAX package's ``library/chem.py`` (numpy only), with its own copy of
``constants/unimod_common.tsv``. All constants are standard public
monoisotopic masses (IUPAC/NIST).

Vectorized numpy throughout; all functions accept arrays of sequences
encoded as residue-mass matrices.
"""

from __future__ import annotations

import numpy as np

MASS_PROTON = 1.00727646662
MASS_H2O = 18.01056468403
MASS_NH3 = 17.02654910112
MASS_CO = 27.99491461957

# residue -> monoisotopic mass
AA_MASS = {
    "G": 57.02146372376,
    "A": 71.03711378804,
    "S": 87.03202840472,
    "P": 97.05276384885,
    "V": 99.06841391313,
    "T": 101.04767846841,
    "C": 103.00918447779,
    "L": 113.08406397713,
    "I": 113.08406397713,
    "N": 114.04292744138,
    "D": 115.02694302429,
    "Q": 128.05857750566,
    "K": 128.09496301519,
    "E": 129.04259308797,
    "M": 131.04048491299,
    "H": 137.05891185845,
    "F": 147.06841391299,
    "U": 150.95363508112,  # selenocysteine
    "R": 156.10111102405,
    "Y": 163.06332853255,
    "W": 186.07931294986,
}

# residue -> elemental composition (C, H, N, O, S) of the residue (minus H2O)
AA_COMPOSITION = {
    "G": (2, 3, 1, 1, 0),
    "A": (3, 5, 1, 1, 0),
    "S": (3, 5, 1, 2, 0),
    "P": (5, 7, 1, 1, 0),
    "V": (5, 9, 1, 1, 0),
    "T": (4, 7, 1, 2, 0),
    "C": (3, 5, 1, 1, 1),
    "L": (6, 11, 1, 1, 0),
    "I": (6, 11, 1, 1, 0),
    "N": (4, 6, 2, 2, 0),
    "D": (4, 5, 1, 3, 0),
    "Q": (5, 8, 2, 2, 0),
    "K": (6, 12, 2, 1, 0),
    "E": (5, 7, 1, 3, 0),
    "M": (5, 9, 1, 1, 1),
    "H": (6, 7, 3, 1, 0),
    "F": (9, 9, 1, 1, 0),
    "U": (3, 5, 1, 1, 0),  # Se tracked via S channel approximation
    "R": (6, 12, 4, 1, 0),
    "Y": (9, 9, 1, 2, 0),
    "W": (11, 10, 2, 1, 0),
}

# modification name -> (delta mass, (C,H,N,O,S) delta composition)
# site is encoded separately as Mod@Site
MOD_TABLE = {
    "Carbamidomethyl": (57.02146373, (2, 3, 1, 1, 0)),
    "Oxidation": (15.99491462, (0, 0, 0, 1, 0)),
    "Acetyl": (42.01056468, (2, 2, 0, 1, 0)),
    "Phospho": (79.96633089, (0, 1, 0, 3, 0)),
    "Methyl": (14.01565006, (1, 2, 0, 0, 0)),
    "Dimethyl": (28.03130013, (2, 4, 0, 0, 0)),
    "Trimethyl": (42.04695019, (3, 6, 0, 0, 0)),
    "GlyGly": (114.04292744, (4, 6, 2, 2, 0)),
    "Deamidated": (0.98401558, (0, -1, -1, 1, 0)),
    "Gln->pyro-Glu": (-17.02654910, (0, -3, -1, 0, 0)),
    "Cysteinyl": (119.00410999, (3, 5, 1, 2, 1)),
    "mTRAQ": (140.09496302, (7, 12, 2, 1, 0)),
    "mTRAQ:13C(3)15N(1)": (144.10206222, (7, 12, 2, 1, 0)),
    "mTRAQ:13C(6)15N(2)": (148.10916143, (7, 12, 2, 1, 0)),
    "Dimethyl:2H(4)": (32.05640669, (2, 4, 0, 0, 0)),
    "Dimethyl:2H(6)13C(2)": (36.07566741, (2, 4, 0, 0, 0)),
    "Label:13C(6)15N(2)": (8.01419881, (0, 0, 0, 0, 0)),
    "Label:13C(6)15N(4)": (10.00826859, (0, 0, 0, 0, 0)),
    "SILAC": (0.0, (0, 0, 0, 0, 0)),
}


# UniMod accession -> modification name (populated from the generated
# table; consumed by library loaders parsing '(UniMod:N)' tokens)
UNIMOD_ID_TO_NAME: dict[int, str] = {}


def _load_unimod_table() -> int:
    """Merge constants/unimod_common.tsv (the ~100 most-used UniMod mods,
    generated by scripts/generate_unimod_table.py) into MOD_TABLE.

    Fills the coverage role of alphabase's bundled UniMod table in the
    reference (mod names used throughout alphadia/libtransform/). The
    hand-curated entries above keep precedence."""
    from pathlib import Path

    path = Path(__file__).parents[1] / "constants" / "unimod_common.tsv"
    n = 0
    for line in path.read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        name, _formula, mass, c, h, nn, o, s, uid, *_ = line.split("\t") + [""]
        MOD_TABLE.setdefault(
            name, (float(mass), (int(c), int(h), int(nn), int(o), int(s)))
        )
        if uid:
            UNIMOD_ID_TO_NAME.setdefault(int(uid), name)
        n += 1
    return n


_load_unimod_table()

# natural isotope abundances per tracked element, neutrons offset 0..3
_ISOTOPES = {
    "C": [0.9893, 0.0107, 0.0, 0.0],
    "H": [0.999885, 0.000115, 0.0, 0.0],
    "N": [0.99636, 0.00364, 0.0, 0.0],
    "O": [0.99757, 0.00038, 0.00205, 0.0],
    "S": [0.9499, 0.0075, 0.0425, 0.0001],
}
_ELEMENT_ORDER = ["C", "H", "N", "O", "S"]


# isotope/element monoisotopic masses for composition formulas like
# "H(-2)2H(8)13C(2)" (alphabase composition syntax)
_ELEMENT_MASS = {
    "H": 1.00782503207,
    "2H": 2.01410177785,
    "C": 12.0,
    "13C": 13.00335483507,
    "N": 14.0030740048,
    "15N": 15.0001088989,
    "O": 15.9949146196,
    "18O": 17.9991610,
    "S": 31.97207100,
    "P": 30.97376163,
    "Se": 79.9165213,
    "Na": 22.9897692809,
    "K": 38.96370668,
    "Ca": 39.96259098,
    "Fe": 55.9349375,
    "F": 18.99840322,
    "Cl": 34.96885268,
    "Br": 78.9183371,
    "I": 126.904473,
    "Mg": 23.9850417,
    "Zn": 63.9291422,
    "Cu": 62.9295975,
    "Li": 7.0160034,
}


def parse_composition(formula: str) -> float:
    """Monoisotopic mass of an alphabase-style composition string,
    e.g. 'H(-2)2H(8)13C(2)' (reference: custom_modifications in
    constants/default.yaml)."""
    import re

    mass = 0.0
    for elem, count in re.findall(r"(\d*[A-Z][a-z]?)\((-?\d+)\)", formula):
        if elem not in _ELEMENT_MASS:
            raise KeyError(f"unknown element/isotope '{elem}' in '{formula}'")
        mass += _ELEMENT_MASS[elem] * int(count)
    return mass


def register_custom_modification(name: str, composition: str) -> None:
    """Add a user-defined modification (config `custom_modifications`)."""
    base = name.split("@")[0]
    MOD_TABLE[base] = (parse_composition(composition), (0, 0, 0, 0, 0))


def parse_mod_spec(spec: str) -> list[tuple[str, str]]:
    """Parse 'Mod@Site;Mod@Site' into [(mod, site), ...]."""
    out = []
    for part in str(spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        if "@" in part:
            mod, site = part.rsplit("@", 1)
        else:
            mod, site = part, "Any"
        out.append((mod, site))
    return out


def mod_delta_mass(mod_name: str) -> float:
    base = mod_name.split("@")[0]
    if base not in MOD_TABLE:
        raise KeyError(f"Unknown modification '{mod_name}'")
    return MOD_TABLE[base][0]


def residue_masses(sequence: str, mods: str = "", mod_sites: str = "") -> np.ndarray:
    """Per-residue masses with modifications applied.

    ``mods`` is a ';'-separated list of modification names,
    ``mod_sites`` the matching ';'-separated residue positions
    (1-based; 0 = N-term applied to residue 1, -1 = C-term applied to the
    last residue) — the alphabase site convention the reference libraries use.
    """
    masses = np.array([AA_MASS[a] for a in sequence], dtype=np.float64)
    if mods:
        names = [m for m in str(mods).split(";") if m]
        sites = [s for s in str(mod_sites).split(";") if s != ""]
        if len(names) != len(sites):
            # a silent zip() truncation here would drop modification masses
            # (e.g. an MBR/flat library with a malformed mod_sites column)
            raise ValueError(
                f"mods/mod_sites length mismatch for '{sequence}': "
                f"{len(names)} mods vs {len(sites)} sites ({mods!r} / {mod_sites!r})"
            )
        for name, site in zip(names, sites):
            pos = int(site)
            idx = 0 if pos <= 0 else min(pos - 1, len(masses) - 1)
            if pos == -1:
                idx = len(masses) - 1
            masses[idx] += mod_delta_mass(name)
    return masses


def precursor_mz(sequence: str, charge: int, mods: str = "", mod_sites: str = "") -> float:
    m = residue_masses(sequence, mods, mod_sites).sum() + MASS_H2O
    return m / charge + MASS_PROTON


def fragment_mz_arrays(
    sequence: str,
    mods: str = "",
    mod_sites: str = "",
    max_charge: int = 2,
    types: tuple[str, ...] = ("b", "y"),
) -> dict[str, np.ndarray]:
    """Return {f'{type}_z{z}': mz[n_res-1]} fragment m/z ladders."""
    masses = residue_masses(sequence, mods, mod_sites)
    prefix = np.cumsum(masses)[:-1]  # b_i = sum of first i residues
    total = masses.sum()
    out = {}
    for t in types:
        if t == "b":
            neutral = prefix
        elif t == "y":
            neutral = total - prefix + MASS_H2O
        elif t == "a":
            neutral = prefix - MASS_CO
        elif t == "c":
            neutral = prefix + MASS_NH3
        elif t == "x":
            neutral = total - prefix + MASS_H2O + MASS_CO - 2 * 1.00782503207
        elif t == "z":
            neutral = total - prefix + MASS_H2O - MASS_NH3 + 1.00782503207
        else:
            raise ValueError(f"unsupported fragment type {t}")
        for z in range(1, max_charge + 1):
            out[f"{t}_z{z}"] = neutral / z + MASS_PROTON
    return out


# ----------------------------------------------------------------------
# isotope envelopes
# ----------------------------------------------------------------------
def _element_power_dist(abund: list[float], n: np.ndarray, k_max: int = 4) -> np.ndarray:
    """Isotope distribution of n atoms of one element, truncated to k_max peaks.

    Vectorized truncated multinomial expansion of (a0 + a1 x + a2 x^2 + a3 x^3)^n.
    """
    a0, a1, a2, a3 = abund
    n = n.astype(np.float64)
    with np.errstate(divide="ignore"):
        # work relative to a0^n to stay in float range; renormalize at the end
        r1 = np.where(a0 > 0, a1 / a0, 0.0)
        r2 = np.where(a0 > 0, a2 / a0, 0.0)
        r3 = np.where(a0 > 0, a3 / a0, 0.0)
    out = np.zeros((len(n), k_max), dtype=np.float64)
    out[:, 0] = 1.0
    if k_max > 1:
        out[:, 1] = n * r1
    if k_max > 2:
        out[:, 2] = n * (n - 1) / 2 * r1**2 + n * r2
    if k_max > 3:
        out[:, 3] = (
            n * (n - 1) * (n - 2) / 6 * r1**3 + n * (n - 1) * r1 * r2 + n * r3
        )
    return out


def isotope_envelopes(compositions: np.ndarray, k_max: int = 4) -> np.ndarray:
    """Relative isotope intensities (normalized to the monoisotopic peak = 1).

    Parameters
    ----------
    compositions : int array [n, 5] — atom counts in _ELEMENT_ORDER (C,H,N,O,S).

    Returns
    -------
    f32 [n, k_max], envelope relative to max peak (matches the reference's
    i_0..i_k columns which are relative abundances).
    """
    n = compositions.shape[0]
    dist = np.zeros((n, k_max), dtype=np.float64)
    dist[:, 0] = 1.0
    for e_i, elem in enumerate(_ELEMENT_ORDER):
        d = _element_power_dist(_ISOTOPES[elem], compositions[:, e_i], k_max)
        # convolve truncated
        new = np.zeros_like(dist)
        for k in range(k_max):
            for j in range(k + 1):
                new[:, k] += dist[:, j] * d[:, k - j]
        dist = new
    dist /= dist.sum(axis=1, keepdims=True)
    return dist.astype(np.float32)


def peptide_compositions(
    sequences, mods_list=None, mod_sites_list=None
) -> np.ndarray:
    """Elemental composition (C,H,N,O,S) incl. H2O terminus for each peptide."""
    n = len(sequences)
    comp = np.zeros((n, 5), dtype=np.int64)
    lut = np.zeros((128, 5), dtype=np.int64)
    for aa, c in AA_COMPOSITION.items():
        lut[ord(aa)] = c
    for i, seq in enumerate(sequences):
        arr = np.frombuffer(seq.encode(), dtype=np.uint8)
        comp[i] = lut[arr].sum(axis=0)
        comp[i, 1] += 2  # H2O
        comp[i, 3] += 1
        if mods_list is not None and mods_list[i]:
            for name in str(mods_list[i]).split(";"):
                if not name:
                    continue
                base = name.split("@")[0]
                if base in MOD_TABLE:
                    comp[i] += np.array(MOD_TABLE[base][1], dtype=np.int64)
    return comp
