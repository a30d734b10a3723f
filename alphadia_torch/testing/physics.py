"""Deterministic peptide "physics": sequence-determined RT, charge, MS2
and ion-mobility ground truth for synthetic experiments.

Role: the training/evaluation world for the packaged property models
(models/property_models.py), standing in for the measured chemistry that
trains alphaPeptDeep in the reference (alphadia/libtransform/prediction.py).
The rules are grounded in published peptide chemistry — additive
hydrophobicity with neighbor interactions (Krokhin SSRCalc), the mobile
proton model of CID fragmentation (proline / aspartate cleavage effects),
basic-residue-driven charge states, and a CCS ~ (m/z)^0.6 power law — plus
a seeded random interaction table so the mapping is richer than any
hand-written heuristic: a model must LEARN it, not hard-code it.

Everything is a pure function of (sequence, charge, world seed). Each
seed is one "laboratory/batch" with its own interaction-table
idiosyncrasies: the packaged property models train on a MIXTURE of world
seeds and are gated and e2e-tested on worlds they never saw
(scripts/train_property_models.py), so evaluation measures transfer of
the shared chemistry, not memorization of one world's random tables.

The port's own copy of the JAX package's ``testing/physics.py``, equal to
it bit for bit, with column dicts of numpy arrays for its frames.
"""

from __future__ import annotations

import numpy as np

AA = "ACDEFGHIKLMNPQRSTVWYU"
_IDX = {a: i for i, a in enumerate(AA)}

# Krokhin et al. 2004 retention coefficients (public constants)
_RC = {
    "W": 11.0, "F": 10.5, "L": 9.6, "I": 8.4, "M": 5.8, "V": 5.0,
    "Y": 4.0, "A": 0.8, "T": 0.4, "P": 0.2, "E": 0.0, "D": -0.5,
    "C": -0.8, "S": -0.8, "Q": -0.9, "G": -0.9, "N": -1.2, "R": -1.3,
    "H": -1.3, "K": -1.9, "U": -0.8,
}

FRAG_COLS = ("b_z1", "b_z2", "y_z1", "y_z2")

# monoisotopic residue masses for the mobility power law
_MASS = {
    "G": 57.02146, "A": 71.03711, "S": 87.03203, "P": 97.05276,
    "V": 99.06841, "T": 101.04768, "C": 103.00919, "L": 113.08406,
    "I": 113.08406, "N": 114.04293, "D": 115.02694, "Q": 128.05858,
    "K": 128.09496, "E": 129.04259, "M": 131.04049, "H": 137.05891,
    "F": 147.06841, "R": 156.10111, "Y": 163.06333, "W": 186.07931,
    "U": 150.95364,
}


class PeptidePhysics:
    """One seeded world; all outputs deterministic given (sequence, charge)."""

    def __init__(self, seed: int = 2026):
        rng = np.random.default_rng(seed)
        n = len(AA)
        # nearest-neighbor RT interaction (symmetric-ish, Krokhin-style)
        self.pair_rt = rng.normal(0.0, 0.9, (n, n))
        # cleavage-site modulation by the flanking residue pair (log scale)
        self.cleave = rng.normal(0.0, 0.35, (n, n))
        # per-residue mobility perturbation
        self.mob_aa = rng.normal(0.0, 0.012, n)

    # -- helpers ---------------------------------------------------------
    def _ids(self, seq: str) -> np.ndarray:
        return np.array([_IDX.get(a, 0) for a in seq], np.int64)

    # -- retention -------------------------------------------------------
    def rt_norm(self, sequences) -> np.ndarray:
        """Normalized retention in [0, 1] (fixed affine squash)."""
        out = np.empty(len(sequences), np.float64)
        for k, s in enumerate(sequences):
            ids = self._ids(s)
            base = sum(_RC.get(a, 0.0) for a in s)
            pair = self.pair_rt[ids[:-1], ids[1:]].sum() if len(s) > 1 else 0.0
            # N-terminal damping + mild length nonlinearity (SSRCalc)
            nterm = -0.3 * sum(_RC.get(a, 0.0) for a in s[:3])
            length = -0.02 * max(len(s) - 20, 0) * abs(base)
            out[k] = base + 0.8 * pair + nterm + length
        # fixed world-level squash: tryptic 7-30mers land mostly in [0, 1]
        return np.clip((out + 15.0) / 90.0, 0.0, 1.0).astype(np.float32)

    # -- charge ----------------------------------------------------------
    def charge_probs(self, sequences, max_charge: int = 6) -> np.ndarray:
        """P(charge state z observable), multi-label over z = 1..max.

        Calibrated to published tryptic ESI priors (Meier et al. 2021
        Fig. 1a and the peptdeep training corpora): a trypsin-faithful
        peptide (one C-terminal K/R, no internal K/R, occasional H)
        centers at z ≈ 2–3, with 2+/3+ dominating and 4+ reserved for
        long / internally basic (missed-cleavage) peptides; charge grows
        with basic-residue count and length.
        """
        zs = np.arange(1, max_charge + 1, dtype=np.float64)
        out = np.empty((len(sequences), max_charge), np.float32)
        for k, s in enumerate(sequences):
            basic = sum(s.count(a) for a in "KRH")
            center = 1.0 + 0.45 * basic + len(s) / 40.0
            out[k] = np.exp(-0.5 * ((zs - center) / 0.7) ** 2)
        return out

    # -- ion mobility ----------------------------------------------------
    def mobility(self, sequences, charges) -> np.ndarray:
        """1/K0 from a CCS ~ mass^(2/3)/z power law + residue perturbation."""
        out = np.empty(len(sequences), np.float32)
        for k, (s, z) in enumerate(zip(sequences, charges)):
            mass = sum(_MASS.get(a, 110.0) for a in s) + 18.01056
            seq_term = self.mob_aa[self._ids(s)].sum()
            out[k] = 0.35 + 0.45 * (mass / 1000.0) ** 0.66 / max(int(z), 1) + seq_term
        return out

    # -- fragmentation ---------------------------------------------------
    def ms2_matrix(self, sequence: str, charge: int) -> np.ndarray:
        """Relative intensities [n_sites, 4] for FRAG_COLS (max-normalized).

        Mobile-proton CID rules: y > b baseline; enhanced y N-terminal to
        proline; enhanced b C-terminal to D/E (stronger when protons are
        sequestered by basic residues); doubly charged fragments only for
        long fragments of multiply charged precursors; seeded pair-table
        modulation on top.
        """
        s = sequence
        n_sites = len(s) - 1
        if n_sites < 1:
            return np.zeros((0, 4), np.float32)
        ids = self._ids(s)
        pos = np.arange(n_sites, dtype=np.float64)
        hump = 0.3 + 0.7 * np.exp(
            -0.5 * ((pos - n_sites / 2.0) / max(n_sites / 3.0, 1.0)) ** 2
        )
        mod = np.exp(self.cleave[ids[:-1], ids[1:]])

        basic = sum(s.count(a) for a in "KRH")
        mobile = max(int(charge) - basic, 0)  # mobile protons
        b_w = 0.55 * (0.5 + 0.5 * min(mobile, 2))
        y_w = 1.0

        b = b_w * hump * mod
        y = y_w * hump * mod
        for i in range(n_sites):
            if s[i + 1] == "P":  # proline effect: strong y, weak b
                y[i] *= 3.0
                b[i] *= 0.4
            if s[i] in "DE" and mobile == 0:  # aspartate effect
                b[i] *= 2.5
                y[i] *= 1.5
        # C-terminal K/R anchors y ions (tryptic)
        if s[-1] in "KR":
            y *= 1.3

        # doubly charged fragments: need length >= 6 and precursor z >= 2
        blen = pos + 1
        ylen = len(s) - blen
        b2 = b * np.clip((blen - 5) / 8.0, 0.0, 0.5) * (charge >= 2)
        y2 = y * np.clip((ylen - 5) / 8.0, 0.0, 0.6) * (charge >= 2)

        out = np.stack([b, b2, y, y2], axis=1)
        peak = out.max()
        return (out / peak if peak > 0 else out).astype(np.float32)

    # -- bulk fragment intensities for a flat library --------------------
    def fill_library_intensities(self, precursor_df, fragment_df) -> None:
        """Overwrite fragment_df['intensity'] in place with physics truth
        (rows addressed via flat_frag_start/stop; b=98, y=121 types)."""
        inten = np.array(fragment_df["intensity"], dtype=np.float32)
        ftype = np.asarray(fragment_df["type"])
        fcharge = np.asarray(fragment_df["charge"])
        fnum = np.asarray(fragment_df["number"])
        for seq, z, a, b_ in zip(
            precursor_df["sequence"],
            precursor_df["charge"],
            precursor_df["flat_frag_start_idx"],
            precursor_df["flat_frag_stop_idx"],
        ):
            mat = self.ms2_matrix(str(seq), int(z))
            for i in range(int(a), int(b_)):
                t, fz, num = ftype[i], int(fcharge[i]), int(fnum[i])
                site = num - 1 if t == 98 else len(seq) - 1 - num
                if 0 <= site < len(mat) and fz in (1, 2):
                    col = (0 if t == 98 else 2) + (fz - 1)
                    inten[i] = mat[site, col]
        fragment_df["intensity"] = inten
