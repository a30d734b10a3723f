"""Decoy generation: the JAX package's ``library/decoy.py`` on column dicts.

- nothing happens when the library already holds decoys;
- ``diann`` decoys mutate the second and the second-to-last residue with the
  DIA-NN mutation table; ``pseudo_reverse`` reverses all but the C-terminal
  residue;
- decoys keep their target's elution group (the FDR competition group),
  fragment intensities, RT and mobility; their precursor and fragment m/z
  are computed from the mutated sequence;
- the decoys are appended, the precursors sorted by elution group (stable,
  so a decoy follows its target) and ``precursor_idx`` numbered anew.
"""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.library import chem
from alphadia_torch.library.pipeline import ProcessingStep
from alphadia_torch.library.speclib import SpecLibBase, SpecLibFlat, mod_seq_charge_hash, str_col
from alphadia_torch.utils.frame import concat, copy_frame, factorize, n_rows, take

logger = logging.getLogger(__name__)

# DIA-NN style mutation map (residue -> replacement)
_DIANN_FROM = "GAVLIFMPWSCTYHKRQEND"
_DIANN_TO = "LLLVVLLLLTSSSSLLNDQE"
_MUTATE = dict(zip(_DIANN_FROM, _DIANN_TO))
_LOSS_MASS = {0: 0.0, 17: chem.MASS_NH3, 18: chem.MASS_H2O}


def _mutate_diann(seq: str) -> str:
    if len(seq) < 3:
        return seq
    chars = list(seq)
    chars[1] = _MUTATE.get(chars[1], chars[1])
    chars[-2] = _MUTATE.get(chars[-2], chars[-2])
    return "".join(chars)


def _pseudo_reverse(seq: str) -> str:
    return seq[:-1][::-1] + seq[-1]


def _shift_sites(sites: str, permutation) -> str:
    """1-based modification sites through a residue permutation."""
    if not sites:
        return sites
    out = []
    for s in str(sites).split(";"):
        p = int(s)
        out.append(str(p) if p <= 0 else str(permutation[p - 1] + 1))
    return ";".join(out)


def _sorted_by_elution_group(prec: dict) -> dict:
    out = take(prec, np.argsort(prec["elution_group_idx"], kind="stable"))
    out["precursor_idx"] = np.arange(n_rows(out), dtype=np.uint32)
    return out


def _text(values) -> list[str]:
    """A string column as strings, a missing value as ``""``."""
    return ["" if v is None or (isinstance(v, float) and np.isnan(v)) else str(v) for v in values]


def generate_flat_decoys(flat: SpecLibFlat, method: str = "diann") -> SpecLibFlat:
    """Decoys of a flat library (a flat input saved without decoys). Each
    flat fragment row's m/z is computed from the mutated sequence through
    its (type, position, charge, loss); ``position`` is the cleavage-site
    index of the ladder. Intensities, RT, mobility and the target's
    elution group are kept."""
    if method != "diann":
        raise ValueError(f"flat decoys support 'diann' only, got {method}")

    prec = copy_frame(flat.precursor_df)
    n = n_rows(prec)
    if "decoy" in prec and len(np.unique(prec["decoy"])) > 1:
        logger.info("Decoys already present, skipping flat decoy generation")
        return flat
    if "decoy" not in prec:
        prec["decoy"] = np.zeros(n, np.uint8)
    mods = _text(prec["mods"]) if "mods" in prec else [""] * n
    sites = _text(prec["mod_sites"]) if "mod_sites" in prec else [""] * n
    if "elution_group_idx" not in prec:
        prec["elution_group_idx"] = factorize(mod_seq_charge_hash(prec["sequence"], mods, prec["charge"])).astype(
            np.uint32
        )

    frag = copy_frame(flat.fragment_df)
    fmz_col = "mz_library" if "mz_library" in frag else "mz"
    pmz_cols = [c for c in ("mz_library", "precursor_mz", "mz") if c in prec]

    # the diann mutation keeps residue positions: mod_sites unchanged
    dseqs = [_mutate_diann(s) for s in prec["sequence"]]
    dprec = copy_frame(prec)
    dprec["sequence"] = np.array(dseqs, dtype=object)
    dprec["decoy"] = np.ones(n, np.uint8)
    d_pmz = np.array(
        [chem.precursor_mz(s, int(z), m, ms) for s, z, m, ms in zip(dseqs, prec["charge"], mods, sites)],
        dtype=np.float32,
    )
    for c in pmz_cols:
        dprec[c] = d_pmz

    ftype = frag["type"]
    fpos = frag["position"]
    fz = np.maximum(frag["charge"].astype(np.int32), 1)
    floss = frag["loss_type"]
    new_mz = frag[fmz_col].astype(np.float32).copy()
    starts = prec["flat_frag_start_idx"]
    stops = prec["flat_frag_stop_idx"]
    for i in range(n):
        a, b = int(starts[i]), int(stops[i])
        if b <= a:
            continue
        types_here = tuple(sorted({chr(t) for t in ftype[a:b]}))
        ladders = chem.fragment_mz_arrays(dseqs[i], mods[i], sites[i], max_charge=int(fz[a:b].max()), types=types_here)
        for j in range(a, b):
            lad = ladders[f"{chr(ftype[j])}_z{int(fz[j])}"]
            p = int(fpos[j])
            if 0 <= p < len(lad):
                new_mz[j] = lad[p] - _LOSS_MASS.get(int(floss[j]), 0.0) / int(fz[j])
    dfrag = copy_frame(frag)
    dfrag[fmz_col] = new_mz

    # decoy blocks after the target blocks; each precursor's start/stop keep
    # it linked to its fragments through the sort
    n_frag = n_rows(frag)
    dprec["flat_frag_start_idx"] = starts + n_frag
    dprec["flat_frag_stop_idx"] = stops + n_frag
    out_prec = _sorted_by_elution_group(concat([prec, dprec]))
    logger.info("Generated %s flat decoys (%s)", f"{n:,}", method)
    return SpecLibFlat(out_prec, concat([frag, dfrag]))


class DecoyGenerator(ProcessingStep):
    def __init__(self, decoy_type: str = "diann"):
        self.decoy_type = decoy_type

    def validate(self, input_) -> bool:
        return isinstance(input_, SpecLibBase)

    def forward(self, lib: SpecLibBase) -> SpecLibBase:
        df = lib.precursor_df
        if "decoy" not in df:
            df["decoy"] = np.zeros(n_rows(df), np.uint8)
        if len(np.unique(df["decoy"])) > 1:
            logger.info("Decoys already present, skipping decoy generation")
            return lib

        decoy = lib.copy()
        ddf = decoy.precursor_df
        if self.decoy_type == "diann":
            # the mutation keeps residue positions: mod_sites unchanged
            ddf["sequence"] = np.array([_mutate_diann(s) for s in ddf["sequence"]], dtype=object)
        elif self.decoy_type == "pseudo_reverse":
            new_seqs, new_sites = [], []
            for s, sites in zip(ddf["sequence"], str_col(ddf, "mod_sites")):
                n = len(s)
                perm = np.concatenate([np.arange(n - 1)[::-1], [n - 1]])
                new_seqs.append(_pseudo_reverse(s))
                new_sites.append(_shift_sites(sites, np.argsort(perm)))
            ddf["sequence"] = np.array(new_seqs, dtype=object)
            if "mod_sites" in ddf:
                ddf["mod_sites"] = np.array(new_sites, dtype=object)
        else:
            raise ValueError(f"unknown decoy_type {self.decoy_type}")

        ddf["decoy"] = np.ones(n_rows(ddf), np.uint8)
        decoy.calc_precursor_mz()
        want = list(lib.charged_frag_types)
        max_charge = max((int(c.split("_z")[1]) for c in want), default=2)
        types = tuple(sorted({c.split("_z")[0] for c in want})) or ("b", "y")
        decoy.calc_fragment_mz(max_charge=max_charge, types=types)
        # calc_fragment_mz gives every type x charge: keep the library's own
        # columns, so that the m/z matrix stays as wide as the intensities
        if want and decoy.charged_frag_types != want:
            col = {c: j for j, c in enumerate(decoy.charged_frag_types)}
            mz = np.zeros((len(decoy.fragment_mz), len(want)), np.float32)
            for j, c in enumerate(want):
                if c in col:
                    mz[:, j] = decoy.fragment_mz[:, col[c]]
            decoy.fragment_mz, decoy.charged_frag_types = mz, want

        lib.append(decoy)
        lib.precursor_df = _sorted_by_elution_group(lib.precursor_df)
        return lib
