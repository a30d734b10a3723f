"""Library harmonization steps: ``PrecursorInitializer``, ``AnnotateFasta``,
``IsotopeGenerator``, ``RTNormalization``; the JAX package's
``library/harmonize.py`` on column dicts, with pandas' results where they
matter (first-appearance elution groups, rows kept in order)."""

from __future__ import annotations

import logging

import numpy as np

from alphadia_torch.library.pipeline import ProcessingStep
from alphadia_torch.library.speclib import SpecLibBase
from alphadia_torch.utils.frame import factorize, n_rows, take, unique_in_order

logger = logging.getLogger(__name__)


class PrecursorInitializer(ProcessingStep):
    """The canonical precursor columns; optionally drop the input's decoys."""

    def __init__(self, drop_decoys: bool = False):
        self.drop_decoys = drop_decoys

    def validate(self, input_) -> bool:
        return isinstance(input_, SpecLibBase)

    def forward(self, lib: SpecLibBase) -> SpecLibBase:
        df = lib.precursor_df
        n = n_rows(df)
        if self.drop_decoys and "decoy" in df:
            lib.precursor_df = df = take(df, df["decoy"] == 0)
            n = n_rows(df)
        if "decoy" not in df:
            df["decoy"] = np.zeros(n, np.uint8)
        if "channel" not in df:
            df["channel"] = np.zeros(n, np.uint32)
        if "mods" not in df:
            df["mods"] = np.full(n, "", dtype=object)
        if "mod_sites" not in df:
            df["mod_sites"] = np.full(n, "", dtype=object)
        lib.hash_precursors()
        if "elution_group_idx" not in df:
            # one group per (modified sequence, charge): decoy and channel
            # copies inherit it and compete, charge states stay apart
            df["elution_group_idx"] = factorize(df["mod_seq_charge_hash"]).astype(np.uint32)
        df["precursor_idx"] = np.arange(n, dtype=np.uint32)
        if "nAA" not in df:
            df["nAA"] = np.array([len(s) for s in df["sequence"]], dtype=np.int64).astype(np.uint8)
        return lib


class AnnotateFasta(ProcessingStep):
    """Proteins and genes of each precursor from FASTA files."""

    def __init__(self, fasta_paths: list[str], drop_unannotated: bool = True):
        self.fasta_paths = fasta_paths
        self.drop_unannotated = drop_unannotated

    def validate(self, input_) -> bool:
        return isinstance(input_, SpecLibBase) and len(self.fasta_paths) > 0

    def forward(self, lib: SpecLibBase) -> SpecLibBase:
        from alphadia_torch.library.digest import read_fasta

        seqs = unique_in_order(np.asarray(lib.precursor_df["sequence"], dtype=object)).tolist()
        pep_prot: dict[str, set] = {s: set() for s in seqs}
        pep_gene: dict[str, set] = {s: set() for s in seqs}
        # peptides indexed by their 6-mer prefix; shorter ones get a
        # substring scan of their own (no 6-mer window can match them)
        by_prefix: dict[str, list[str]] = {}
        short = []
        for s in seqs:
            if len(s) >= 6:
                by_prefix.setdefault(s[:6], []).append(s)
            else:
                short.append(s)
        for path in self.fasta_paths:
            proteins = read_fasta(path)
            for prot, gene, pseq in zip(proteins["protein"], proteins["gene"], proteins["sequence"]):
                for i in range(len(pseq) - 5):
                    for cand in by_prefix.get(pseq[i : i + 6], ()):
                        if pseq.startswith(cand, i):
                            pep_prot[cand].add(prot)
                            pep_gene[cand].add(gene)
                for cand in short:
                    if cand in pseq:
                        pep_prot[cand].add(prot)
                        pep_gene[cand].add(gene)
        df = lib.precursor_df
        df["proteins"] = np.array([";".join(sorted(pep_prot[s])) for s in df["sequence"]], dtype=object)
        df["genes"] = np.array([";".join(sorted(pep_gene[s])) for s in df["sequence"]], dtype=object)
        if self.drop_unannotated:
            keep = df["proteins"] != ""
            n_drop = int((~keep).sum())
            if n_drop:
                logger.info("Dropping %d precursors without FASTA annotation", n_drop)
            lib.precursor_df = take(df, keep)
        return lib


class IsotopeGenerator(ProcessingStep):
    """The isotope envelope columns i_0..i_{n-1} from the composition."""

    def __init__(self, n_isotopes: int = 4):
        self.n_isotopes = n_isotopes

    def validate(self, input_) -> bool:
        return isinstance(input_, SpecLibBase)

    def forward(self, lib: SpecLibBase) -> SpecLibBase:
        lib.calc_isotopes(self.n_isotopes)
        return lib


class RTNormalization(ProcessingStep):
    """Library RT to [0, 1] between its 0.1 and 99.9 percentiles; the
    per-run library init maps it onto the run's gradient."""

    def validate(self, input_) -> bool:
        return isinstance(input_, SpecLibBase) and any(
            c in input_.precursor_df for c in ("rt", "rt_library", "irt", "rt_norm")
        )

    def forward(self, lib: SpecLibBase) -> SpecLibBase:
        df = lib.precursor_df
        col = next(c for c in ("rt_library", "rt", "rt_norm", "irt") if c in df)
        rt = np.asarray(df[col], dtype=np.float32)
        lo, hi = np.percentile(rt, [0.1, 99.9])
        if hi - lo <= 0:
            norm = np.zeros_like(rt)
        else:
            norm = np.clip((rt - lo) / (hi - lo), 0.0, 1.0)
        df["rt_norm"] = norm
        # the source column too: the flat library's rt_library is taken from
        # it, and a raw outlier would dominate the run's min-max mapping
        if col != "rt_norm":
            df[col] = norm
        return lib
