"""The port's spectral-library pipeline against the JAX package's, on
identical inputs: ``load_speclib_tsv`` (TSV and CSV transition lists of a
JAX digest with UniMod-annotated modifications, ``_SEQ_`` and bracket
notations), each harmonize step, ``DecoyGenerator`` (``diann`` and
``pseudo_reverse``), ``generate_flat_decoys``, ``FlattenLibrary`` +
``InitFlatColumns``, the precursor hashes and ``chem``.

Tolerance: none. Every column, integer, string or float, equals the JAX
package's in name, order, dtype and value: both packages compute the floats
with the same numpy arithmetic. The transition lists are made as
``tests/e2e/test_tsv_library_e2e.py`` makes its own, from a digest of a few
FASTA proteins, without prediction: fragment m/z from ``chem``, seeded
random intensities and retention times.
"""

import csv

import numpy as np
import pandas as pd
import pytest

from alphadia_torch.library import chem as port_chem
from alphadia_torch.library.decoy import DecoyGenerator, generate_flat_decoys
from alphadia_torch.library.flatten import FlattenLibrary, InitFlatColumns
from alphadia_torch.library.harmonize import AnnotateFasta, IsotopeGenerator, PrecursorInitializer, RTNormalization
from alphadia_torch.library.loader import DynamicLoader, load_speclib_tsv
from alphadia_torch.library.speclib import SpecLibFlat, mod_seq_charge_hash, mod_seq_hash
from alphadia_tpu.library import chem as jax_chem
from alphadia_tpu.library import decoy as jax_decoy
from alphadia_tpu.library import flatten as jax_flatten
from alphadia_tpu.library import harmonize as jax_harmonize
from alphadia_tpu.library import loader as jax_loader
from alphadia_tpu.library import speclib as jax_speclib
from alphadia_tpu.library.digest import digest_fasta

pytest_plugins = ("torch_port_plugin",)

FASTA = """>sp|P001|PROT1 GN=G1
MKWVTFISLLFLFSSAYSRGVFRRDAHKSEVAHRFKDLGEENFKALVLIAFAQYLQQCPFEDHVKLVNEVTEFAK
>sp|P002|PROT2 GN=G2
MTEYKLVVVGAGGVGKSALTIQLIQNHFVDEYDPTIEDSYRKQVVIDGETCLLDILDTAGQEEYSAMRDQYMRTGEGFLCVFAINNTK
>sp|P003|PROT3 GN=G3
MGLSDGEWQLVLNVWGKVEADIPGHGQEVLIRLFKGHPETLEKFDKFKHLKSEDEMKASEDLKKHGATVLTALGGILKKKGHHEAEIKPLAQSHATK
"""
# a FASTA that annotates only some of the digest's peptides
FASTA_PART = """>sp|P002|PROT2 GN=G2
MTEYKLVVVGAGGVGKSALTIQLIQNHFVDEYDPTIEDSYRKQVVIDGETCLLDILDTAGQEEYSAMRDQYMRTGEGFLCVFAINNTK
>tr|Q9|SHORT
SALTIQLIQNHFVDEYDPTIEDSYR
"""
_UNIMOD = {"Carbamidomethyl": 4, "Oxidation": 35, "Acetyl": 1}


def _modified_peptide(seq, mods, sites, bracket=False) -> str:
    if not mods:
        return f"_{seq}_"
    out = list(seq)
    for m, s in sorted(zip(mods.split(";"), [int(x) for x in sites.split(";")]), key=lambda t: -t[1]):
        name = m.split("@")[0]
        out.insert(max(s, 0), f"[{name} ({m.split('@')[1]})]" if bracket else f"(UniMod:{_UNIMOD[name]})")
    return "_" + "".join(out) + "_"


def _digest_library():
    """A JAX digest of FASTA with b/y fragment m/z from chem, seeded random
    intensities (some zero) and normalized retention times."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        fasta = Path(tmp) / "t.fasta"
        fasta.write_text(FASTA)
        lib = digest_fasta([str(fasta)], missed_cleavages=1)
    lib = jax_harmonize.PrecursorInitializer()(lib)
    lib.calc_fragment_mz(max_charge=2, types=("b", "y"))
    rng = np.random.default_rng(0)
    inten = rng.random(lib.fragment_mz_df.shape).astype(np.float32)
    inten[rng.random(inten.shape) < 0.2] = 0.0
    lib.fragment_intensity_df = pd.DataFrame(inten, columns=lib.fragment_mz_df.columns)
    lib.precursor_df["rt_norm"] = rng.random(len(lib.precursor_df)).astype(np.float32)
    return lib


def _write_transition_list(lib, path, variant: str) -> None:
    """Long format, one row per fragment: the columns of
    ``tests/e2e/test_tsv_library_e2e.py`` (``no_stripped`` drops
    StrippedPeptide, ``bracket`` writes the modifications by name)."""
    mz = lib.fragment_mz_df.to_numpy()
    inten = lib.fragment_intensity_df.to_numpy()
    cols = list(lib.fragment_mz_df.columns)
    sep = "," if variant == "csv" else "\t"
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=sep, lineterminator="\n")
        header = ["ModifiedPeptide", "StrippedPeptide", "PrecursorCharge", "PrecursorMz", "Tr_recalibrated",
                  "ProteinGroups", "Genes", "FragmentMz", "RelativeIntensity", "FragmentType", "FragmentCharge",
                  "FragmentSeriesNumber"]
        if variant == "no_stripped":
            header.remove("StrippedPeptide")
        w.writerow(header)
        for r in lib.precursor_df.itertuples(index=False):
            naa = len(r.sequence)
            mp = _modified_peptide(r.sequence, r.mods, r.mod_sites, bracket=variant == "bracket")
            for fi in range(int(r.frag_start_idx), int(r.frag_stop_idx)):
                num = fi - int(r.frag_start_idx) + 1
                for ci, cname in enumerate(cols):
                    if mz[fi, ci] <= 0 or inten[fi, ci] <= 0.001:
                        continue
                    ftype, fz = cname.split("_z")
                    row = [mp, r.sequence, int(r.charge), float(r.precursor_mz), float(r.rt_norm), "PROT", "GENE",
                           float(mz[fi, ci]), float(inten[fi, ci]), ftype, int(fz), num if ftype == "b" else naa - num]
                    if variant == "no_stripped":
                        del row[1]
                    w.writerow(row)


def assert_same_frame(theirs: pd.DataFrame, ours: dict, what: str):
    assert list(theirs.columns) == list(ours), (what, list(theirs.columns), list(ours))
    for c in theirs.columns:
        a, b = theirs[c].to_numpy(), ours[c]
        if a.dtype == object or b.dtype == object:
            assert a.dtype == object and b.dtype == object, (what, c, a.dtype, b.dtype)
            assert list(a) == list(b), (what, c)
        else:
            assert a.dtype == b.dtype, (what, c, a.dtype, b.dtype)
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (what, c)


def assert_same_base(theirs, ours, what: str):
    assert_same_frame(theirs.precursor_df, ours.precursor_df, what)
    assert list(theirs.fragment_mz_df.columns) == ours.charged_frag_types
    for a, b in ((theirs.fragment_mz_df, ours.fragment_mz), (theirs.fragment_intensity_df, ours.fragment_intensity)):
        a = a.to_numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), what


def assert_same_flat(theirs, ours, what: str):
    assert_same_frame(theirs.precursor_df, ours.precursor_df, what)
    assert_same_frame(theirs.fragment_df, ours.fragment_df, what)


VARIANTS = ("tsv", "csv", "no_stripped", "bracket")


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lib")
    lib = _digest_library()
    paths = {}
    for v in VARIANTS:
        paths[v] = tmp / f"lib_{v}.{'csv' if v == 'csv' else 'tsv'}"
        _write_transition_list(lib, paths[v], v)
    fasta = tmp / "part.fasta"
    fasta.write_text(FASTA_PART)
    paths["fasta"] = fasta
    return paths


@pytest.mark.parametrize("variant", VARIANTS)
def test_load_speclib_tsv_matches_jax(tables, variant):
    theirs = jax_loader.load_speclib_tsv(tables[variant])
    ours = load_speclib_tsv(tables[variant])
    assert len(ours.precursor_df["sequence"]) > 50
    assert any(m for m in ours.precursor_df["mods"])
    assert_same_base(theirs, ours, variant)


@pytest.mark.parametrize("fmt,suffix", [("base", ".hdf"), ("flat", ".h5"), ("base_from_the_port", ".hdf5")])
def test_dynamic_loader_reads_both_hdf_formats(tmp_path, tables, flat_pair, fmt, suffix):
    """``DynamicLoader`` on a library the JAX package saved (base: its TSV
    load; flat: flattened with decoys) and on one the port saved: equal to
    the library written, and the JAX package's loader reads it equal."""
    path = tmp_path / f"lib{suffix}"
    if fmt == "flat":
        jflat, _ = flat_pair
        jflat.save_hdf(path)
        ours = DynamicLoader()(path)
        assert isinstance(ours, SpecLibFlat)
        assert_same_flat(jflat, ours, fmt)
        assert_same_flat(jax_loader.load_speclib_hdf(path), ours, fmt)
        return
    jlib = jax_loader.load_speclib_tsv(tables["tsv"])
    if fmt == "base":
        jlib.save_hdf(path)
    else:
        load_speclib_tsv(tables["tsv"]).save_hdf(path, thread_count=2)
    ours = DynamicLoader()(path)
    assert_same_base(jlib, ours, fmt)
    assert_same_base(jax_loader.load_speclib_hdf(path), ours, fmt)


def _harmonized(tables, jax_steps, port_steps):
    jlib, plib = jax_loader.load_speclib_tsv(tables["tsv"]), load_speclib_tsv(tables["tsv"])
    for j, p in zip(jax_steps, port_steps):
        jlib, plib = j(jlib), p(plib)
    return jlib, plib


HARMONIZE = {
    "precursor_initializer": lambda t: ([jax_harmonize.PrecursorInitializer()], [PrecursorInitializer()]),
    "annotate_fasta": lambda t: (
        [jax_harmonize.PrecursorInitializer(), jax_harmonize.AnnotateFasta([str(t["fasta"])])],
        [PrecursorInitializer(), AnnotateFasta([str(t["fasta"])])],
    ),
    "isotopes": lambda t: (
        [jax_harmonize.PrecursorInitializer(), jax_harmonize.IsotopeGenerator()],
        [PrecursorInitializer(), IsotopeGenerator()],
    ),
    "rt_normalization": lambda t: (
        [jax_harmonize.PrecursorInitializer(), jax_harmonize.RTNormalization()],
        [PrecursorInitializer(), RTNormalization()],
    ),
}


@pytest.mark.parametrize("step", sorted(HARMONIZE))
def test_harmonize_step_matches_jax(tables, step):
    jlib, plib = _harmonized(tables, *HARMONIZE[step](tables))
    assert_same_base(jlib, plib, step)
    if step == "annotate_fasta":
        assert 0 < len(plib.precursor_df["proteins"]) < len(load_speclib_tsv(tables["tsv"]).precursor_df["charge"])


def test_precursor_initializer_drops_input_decoys_as_jax(tables):
    jlib, plib = _harmonized(tables, [jax_harmonize.PrecursorInitializer()], [PrecursorInitializer()])
    n = len(plib.precursor_df["decoy"])
    decoy = (np.arange(n) % 3 == 0).astype(np.uint8)
    jlib.precursor_df["decoy"] = decoy
    plib.precursor_df["decoy"] = decoy.copy()
    for c in ("elution_group_idx", "precursor_idx"):
        del jlib.precursor_df[c], plib.precursor_df[c]
    jlib = jax_harmonize.PrecursorInitializer(drop_decoys=True)(jlib)
    plib = PrecursorInitializer(drop_decoys=True)(plib)
    assert len(plib.precursor_df["decoy"]) == n - int(decoy.sum())
    assert_same_base(jlib, plib, "drop_decoys")


def _full_harmonize(tables):
    return _harmonized(
        tables,
        [jax_harmonize.PrecursorInitializer(), jax_harmonize.IsotopeGenerator(), jax_harmonize.RTNormalization()],
        [PrecursorInitializer(), IsotopeGenerator(), RTNormalization()],
    )


@pytest.mark.parametrize("decoy_type", ["diann", "pseudo_reverse"])
def test_decoy_generator_matches_jax(tables, decoy_type):
    jlib, plib = _full_harmonize(tables)
    jlib = jax_decoy.DecoyGenerator(decoy_type)(jlib)
    plib = DecoyGenerator(decoy_type)(plib)
    assert (plib.precursor_df["decoy"] == 1).sum() == (plib.precursor_df["decoy"] == 0).sum()
    assert_same_base(jlib, plib, decoy_type)
    # a library with decoys is left as it is
    again = DecoyGenerator(decoy_type)(plib)
    assert len(again.precursor_df["decoy"]) == len(plib.precursor_df["decoy"])


@pytest.fixture(scope="module")
def flat_pair(tables):
    jlib, plib = _full_harmonize(tables)
    jlib, plib = jax_decoy.DecoyGenerator("diann")(jlib), DecoyGenerator("diann")(plib)
    jflat = jax_flatten.InitFlatColumns()(jax_flatten.FlattenLibrary(12, 0.01)(jlib))
    pflat = InitFlatColumns()(FlattenLibrary(12, 0.01)(plib))
    return jflat, pflat


def test_flatten_and_init_flat_columns_match_jax(flat_pair):
    jflat, pflat = flat_pair
    assert_same_flat(jflat, pflat, "flatten")
    assert {"mz_library", "rt_library", "mobility_library"} <= set(pflat.precursor_df)
    assert (pflat.fragment_df["cardinality"] > 1).any()


def test_generate_flat_decoys_matches_jax(flat_pair):
    jflat, pflat = flat_pair
    # the targets without their elution groups: the decoys group anew
    jt = jflat.precursor_df[jflat.precursor_df["decoy"] == 0].reset_index(drop=True).drop(columns="elution_group_idx")
    targets = pflat.precursor_df["decoy"] == 0
    pt = {k: v[targets] for k, v in pflat.precursor_df.items() if k != "elution_group_idx"}
    theirs = jax_decoy.generate_flat_decoys(jax_speclib.SpecLibFlat(jt, jflat.fragment_df.copy()))
    ours = generate_flat_decoys(SpecLibFlat(pt, {k: v.copy() for k, v in pflat.fragment_df.items()}))
    assert (ours.precursor_df["decoy"] == 1).sum() == targets.sum()
    assert_same_flat(theirs, ours, "flat decoys")


def test_hashes_match_jax(flat_pair):
    _, pflat = flat_pair
    seq, mods, charge = pflat.precursor_df["sequence"], pflat.precursor_df["mods"], pflat.precursor_df["charge"]
    assert np.array_equal(mod_seq_hash(seq, mods), jax_speclib.mod_seq_hash(seq, mods))
    assert np.array_equal(mod_seq_charge_hash(seq, mods, charge), jax_speclib.mod_seq_charge_hash(seq, mods, charge))
    none_mods = [None] * len(seq)
    assert np.array_equal(mod_seq_hash(seq, none_mods), jax_speclib.mod_seq_hash(seq, none_mods))


CHEM_CASES = [
    ("PEPTIDEK", "", ""),
    ("ACDEFGHIKLMNPQRSTVWY", "Carbamidomethyl@C;Oxidation@M", "2;11"),
    ("MKWVTFISLLFLFSSAYSR", "Acetyl@Protein_N-term;Oxidation@M", "0;1"),
    ("SEQMENCER", "Phospho@S;Deamidated@N", "1;6"),
    ("QPEPTIDECK", "Gln->pyro-Glu@Q;Carbamidomethyl@C;GlyGly@K", "1;9;-1"),
]


@pytest.mark.parametrize("seq,mods,sites", CHEM_CASES)
def test_chem_matches_jax(seq, mods, sites):
    for z in (1, 2, 3):
        assert port_chem.precursor_mz(seq, z, mods, sites) == jax_chem.precursor_mz(seq, z, mods, sites)
    types = ("a", "b", "c", "x", "y", "z")
    ours = port_chem.fragment_mz_arrays(seq, mods, sites, max_charge=3, types=types)
    theirs = jax_chem.fragment_mz_arrays(seq, mods, sites, max_charge=3, types=types)
    assert list(ours) == list(theirs)
    for k in ours:
        assert np.array_equal(ours[k], theirs[k]), k
    comp = port_chem.peptide_compositions([seq, seq[::-1]], [mods, ""])
    assert np.array_equal(comp, jax_chem.peptide_compositions([seq, seq[::-1]], [mods, ""]))
    assert np.array_equal(port_chem.isotope_envelopes(comp, 6), jax_chem.isotope_envelopes(comp, 6))


def test_chem_tables_and_compositions_match_jax():
    assert port_chem.MOD_TABLE == jax_chem.MOD_TABLE
    assert port_chem.UNIMOD_ID_TO_NAME == jax_chem.UNIMOD_ID_TO_NAME
    for formula in ("H(-2)2H(8)13C(2)", "C(2)H(3)N(1)O(1)", "13C(6)15N(2)"):
        assert port_chem.parse_composition(formula) == jax_chem.parse_composition(formula)
