"""The port's FASTA digest against the JAX package's, on the CPU: the
precursor library equal exactly (rows in the same order, the strings,
``charge``, ``precursor_mz`` bit for bit, the dtypes).

- A seeded 200-protein FASTA (``testing/fasta.py``), one case per enzyme of
  ``ENZYME_RULES``.
- An ``Any_N-term`` fixed label beside a ``Protein_N-term`` variable mod
  (the label occupies residue 1, the acetyl is not enumerated there).
- Protein N-termini at the first residue and at the second (the JAX
  digest's test for a lost initiator Met: a cleavage after residue 1).
- Residues outside the mass table (X, B, Z): their peptides are dropped.
- Peptides shared between proteins: proteins and genes joined sorted.
"""

import numpy as np
import pytest

from alphadia_torch.library.digest import ENZYME_RULES, digest_fasta, digest_sequence, read_fasta
from alphadia_torch.testing.fasta import write_fasta
from alphadia_tpu.library.digest import digest_fasta as jax_digest_fasta
from alphadia_tpu.library.digest import digest_sequence as jax_digest_sequence
from alphadia_tpu.library.digest import read_fasta as jax_read_fasta

pytest_plugins = ("torch_port_plugin",)

HAND_MADE = """>sp|Q0001|ONE_HUMAN first GN=GA
MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVGDGTQDNLSGAEKAVQVK
>sp|Q0002|TWO_HUMAN met loss GN=GB
MAPEPTIDEKSEQVENCEMRCLAMPSGGGKTAYIAKQRQISFVKWWYLLR
>sp|Q0003|THREE_HUMAN odd residues GN=GC
MXAAGGKPLBTTSSRZZHHKLLPPEPTIDEKAAGGLLR
>tr|Q0004|FOUR_HUMAN shares peptides GN=GA
SEQVENCEMRCLAMPSGGGKNNNMMMCCCKAAAAAAAR
>free_header_without_bars GN=GD
PEPTIDEKSEQVENCEMRQISFVKSHFSRCCKMMCR
>sp|Q0006|SIX_HUMAN cleaved after the first residue GN=GF
RAPEPTIDEKLLGRSSMMTTR
"""


def assert_same_library(ours, theirs):
    jdf, pdf = theirs.precursor_df, ours.precursor_df
    assert list(jdf.columns) == list(pdf)
    assert len(jdf) > 0
    for c in jdf.columns:
        a, b = jdf[c].to_numpy(), pdf[c]
        if b.dtype == object:
            assert list(a) == list(b), c
        else:
            assert a.dtype == b.dtype, c
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), c  # bit for bit


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    return str(write_fasta(tmp_path_factory.mktemp("digest") / "db.fasta", 200, seed=1))


@pytest.mark.parametrize("enzyme", sorted(ENZYME_RULES))
def test_digest_matches_per_enzyme(fasta, enzyme):
    kw = dict(enzyme=enzyme, missed_cleavages=1 if enzyme != "chymotrypsin" else 0)
    assert_same_library(digest_fasta([fasta], **kw), jax_digest_fasta([fasta], **kw))


@pytest.fixture()
def hand_made(tmp_path):
    path = tmp_path / "hand.fasta"
    path.write_text(HAND_MADE)
    return str(path)


@pytest.mark.parametrize(
    "case",
    ["defaults", "fixed_nterm_label", "no_missed_cleavage_more_mods", "trypsin_p_wide"],
)
def test_digest_matches_on_edge_cases(hand_made, tmp_path, case):
    kw = {
        "defaults": {},
        "fixed_nterm_label": dict(
            fixed_modifications="Carbamidomethyl@C;Dimethyl@Any_N-term",
            variable_modifications="Oxidation@M;Acetyl@Protein_N-term",
        ),
        "no_missed_cleavage_more_mods": dict(missed_cleavages=0, max_var_mod_num=3, precursor_len=(5, 40)),
        "trypsin_p_wide": dict(enzyme="trypsin/p", missed_cleavages=2, precursor_charge=(1, 5), precursor_mz=(200.0, 2000.0)),
    }[case]
    second = tmp_path / "second.fasta"
    second.write_text(">sp|Q0005|FIVE_HUMAN second file GN=GE\nMKTAYIAKQRQISFVKWWYLLRPEPTIDEK\n")
    paths = [hand_made, str(second)]
    ours, theirs = digest_fasta(paths, **kw), jax_digest_fasta(paths, **kw)
    assert_same_library(ours, theirs)
    df = ours.precursor_df
    seqs = set(df["sequence"])
    assert not any(set(s) & set("XBZ") for s in seqs)  # residues outside the table drop their peptides
    # a peptide of two proteins names both, sorted
    assert any(";" in p for p in df["proteins"])
    if case == "fixed_nterm_label":
        # the label holds site 0: no acetyl is enumerated beside it
        assert not any("Acetyl" in m for m in df["mods"])
        assert all("Dimethyl@Any_N-term" in m for m in df["mods"])
    if case == "defaults":
        acetyl = {s for s, m in zip(df["sequence"], df["mods"]) if "Acetyl@Protein_N-term" in m}
        # protein N-termini at the first residue and at the second
        assert "MKTAYIAK" in acetyl and "APEPTIDEK" in acetyl and "TAYIAK" not in acetyl


def test_read_fasta_and_digest_sequence_match(hand_made):
    theirs, ours = jax_read_fasta(hand_made), read_fasta(hand_made)
    for c in theirs.columns:
        assert list(theirs[c]) == list(ours[c]), c
    for enzyme in ENZYME_RULES:
        for seq in ours["sequence"]:
            assert digest_sequence(seq, enzyme, 2) == jax_digest_sequence(seq, enzyme, 2)
