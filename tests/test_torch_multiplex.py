"""Multiplexing (``library/multiplex.py``,
``workflow/peptidecentric/multiplexing_handler.py``) and the port's copy of
``testing/physics.py``, against the JAX package on identical numpy inputs
on the CPU.

- ``PeptidePhysics``: every output bit for bit;
- ``MultiplexLibrary`` on a digested dimethyl library (the e2e test's
  channels) and with a translated custom modification: every precursor
  column, the fragment matrices and their types exactly;
- ``multiplex_candidates`` and ``channel_fdr`` (global and channel-wise) on
  the JAX unit tests' frames and on seeded ones: every column exactly;
- on the e2e test's dimethyl world, small: ``SearchStep.load_library``
  with ``library_multiplexing`` gives JAX's channel library; the port's
  step writes ``precursors.parquet`` with ``precursor.channel`` inside the
  e2e test's bounds; ``PeptideCentricWorkflow.requantify`` on a workflow of
  the same search gives channel PSMs with the decoy channel at the null,
  where JAX's handler raises for want of the fragments' calibration.
"""

import json

import numpy as np
import pandas as pd
import pytest

from alphadia_torch.convert import frame_from_pandas

pytest_plugins = ("torch_port_plugin",)

FASTA = """>sp|P001|PROT1 GN=G1
MKWVTFISLLFLFSSAYSRGVFRRDAHKSEVAHRFKDLGEENFKALVLIAFAQYLQQCPFEDHVKLVNEVTEFAK
>sp|P002|PROT2 GN=G2
MTEYKLVVVGAGGVGKSALTIQLIQNHFVDEYDPTIEDSYRKQVVIDGETCLLDILDTAGQEEYSAMRDQYMRTGEGFLCVFAINNTK
>sp|P003|PROT3 GN=G3
MGLSDGEWQLVLNVWGKVEADIPGHGQEVLIRLFKGHPETLEKFDKFKHLKSEDEMKASEDLKKHGATVLTALGGILKKKGHHEAEIKPLAQSHATK
>sp|P004|PROT4 GN=G4
MSKGEELFTGVVPILVELDGDVNGHKFSVSGEGEGDATYGKLTLKFICTTGKLPVPWPTLVTTFSYGVQCFSR
"""


def assert_same(jax_frame, port_frame, where=""):
    """A pandas frame and a column dict: the same columns in order, dtypes
    and values (text as ``str``, NaN equal to NaN)."""
    assert list(jax_frame.columns) == list(port_frame), (where, list(jax_frame.columns), list(port_frame))
    for c in jax_frame.columns:
        a, b = jax_frame[c].to_numpy(), np.asarray(port_frame[c])
        if a.dtype == object or a.dtype.kind == "U":
            assert [str(x) for x in a] == [str(x) for x in b], (where, c)
        else:
            assert a.dtype == b.dtype, (where, c, a.dtype, b.dtype)
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (where, c)


def port_base(lib):
    """A JAX ``SpecLibBase`` as the port's."""
    from alphadia_torch.library.speclib import SpecLibBase

    prec = frame_from_pandas(lib.precursor_df)
    return SpecLibBase(prec, lib.fragment_mz_df.to_numpy().copy(),
                       None if lib.fragment_intensity_df is None else lib.fragment_intensity_df.to_numpy().copy(),
                       list(lib.fragment_mz_df.columns))


# ---------------------------------------------------------------------------
# physics
# ---------------------------------------------------------------------------
def test_physics_matches_jax_bit_for_bit():
    from alphadia_torch.testing.physics import FRAG_COLS, PeptidePhysics
    from alphadia_tpu.testing import physics as jax_physics

    rng = np.random.default_rng(11)
    aa = "ACDEFGHIKLMNPQRSTVWYU"
    seqs = ["".join(rng.choice(list(aa), n)) for n in rng.integers(2, 40, 300)] + ["K", "PEPTIDEK", "DPPEPR"]
    charges = rng.integers(1, 5, len(seqs))
    assert FRAG_COLS == jax_physics.FRAG_COLS
    for seed in (2026, 7):
        ours, theirs = PeptidePhysics(seed), jax_physics.PeptidePhysics(seed)
        for a, b in ((ours.rt_norm(seqs), theirs.rt_norm(seqs)),
                     (ours.charge_probs(seqs), theirs.charge_probs(seqs)),
                     (ours.mobility(seqs, charges), theirs.mobility(seqs, charges))):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for s, z in zip(seqs, charges):
            a, b = ours.ms2_matrix(s, int(z)), theirs.ms2_matrix(s, int(z))
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        # fill_library_intensities on a flat frame
        n = 40
        starts = np.cumsum([0] + [2 * (len(s) - 1) for s in seqs[: n - 1]])
        stops = starts + np.array([2 * (len(s) - 1) for s in seqs[:n]])
        prec = pd.DataFrame({"sequence": seqs[:n], "charge": charges[:n], "flat_frag_start_idx": starts,
                             "flat_frag_stop_idx": stops})
        m = int(stops[-1])
        frag = pd.DataFrame({"intensity": rng.random(m).astype(np.float32),
                             "type": rng.choice([98, 121], m).astype(np.uint8),
                             "charge": rng.integers(1, 4, m).astype(np.uint8),
                             "number": rng.integers(0, 40, m).astype(np.uint8)})
        pf = frame_from_pandas(frag)
        theirs.fill_library_intensities(prec, frag)
        ours.fill_library_intensities(frame_from_pandas(prec), pf)
        assert pf["intensity"].tobytes() == frag["intensity"].to_numpy().tobytes()


# ---------------------------------------------------------------------------
# MultiplexLibrary
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dimethyl_base(tmp_path_factory):
    from alphadia_tpu.library.digest import digest_fasta
    from alphadia_tpu.library.harmonize import IsotopeGenerator, PrecursorInitializer
    from alphadia_tpu.models.prediction import SimplePrediction

    fasta = tmp_path_factory.mktemp("mp") / "t.fasta"
    fasta.write_text(FASTA)
    base = digest_fasta([str(fasta)], missed_cleavages=0, fixed_modifications="Dimethyl@K;Dimethyl@Any_N-term",
                        variable_modifications="")
    return IsotopeGenerator()(SimplePrediction()(PrecursorInitializer()(base))), fasta


def _mapping():
    from torch_workflow_worlds import MULTIPLEX_MAPPING

    return MULTIPLEX_MAPPING


@pytest.mark.parametrize("channels", ["e2e_three", "planted_two", "input_channel_4"])
def test_multiplex_library_matches_jax(dimethyl_base, channels):
    from alphadia_torch.library.multiplex import MultiplexLibrary
    from alphadia_tpu.library.multiplex import MultiplexLibrary as JaxMultiplexLibrary

    base, _ = dimethyl_base
    mapping, input_channel, lib = _mapping(), 0, base.copy()
    if channels == "planted_two":
        mapping = mapping[:2]
    if channels == "input_channel_4":
        # a library already multiplexed: channel 4 as the input channel
        lib = JaxMultiplexLibrary(mapping[:2])(base.copy())
        input_channel = 4
    theirs = JaxMultiplexLibrary(mapping, input_channel)(lib.copy())
    ours = MultiplexLibrary(mapping, input_channel)(port_base(lib))
    assert_same(theirs.precursor_df, ours.precursor_df, channels)
    assert list(theirs.fragment_mz_df.columns) == ours.charged_frag_types
    a, b = theirs.fragment_mz_df.to_numpy(), ours.fragment_mz
    assert a.dtype == b.dtype and np.allclose(a, b, rtol=1e-6, atol=0) and np.array_equal(a, b)
    assert np.array_equal(theirs.fragment_intensity_df.to_numpy(), ours.fragment_intensity)
    assert sorted(set(ours.precursor_df["channel"].tolist())) == sorted(int(m["channel_name"]) for m in mapping)


def test_multiplex_library_translates_a_custom_modification_as_jax(dimethyl_base):
    from alphadia_torch.library import chem
    from alphadia_torch.library.multiplex import MultiplexLibrary
    from alphadia_tpu.library import chem as jax_chem
    from alphadia_tpu.library.multiplex import MultiplexLibrary as JaxMultiplexLibrary

    for c in (chem, jax_chem):
        c.register_custom_modification("HeavyK@K", "C(2)H(4)")
    base, _ = dimethyl_base
    lib = base.copy()
    df = lib.precursor_df
    has_k = df["sequence"].str.contains("K")
    df["mods"] = np.where(has_k, "Methyl@K", df["mods"])
    df["mod_sites"] = np.where(has_k, (df["sequence"].str.find("K") + 1).astype(str), df["mod_sites"])
    lib.calc_precursor_mz()
    mapping = [{"channel_name": 0, "modifications": {}}, {"channel_name": 8, "modifications": {"Methyl@K": "HeavyK@K"}}]
    theirs = JaxMultiplexLibrary(mapping)(lib.copy())
    ours = MultiplexLibrary(mapping)(port_base(lib))
    assert_same(theirs.precursor_df, ours.precursor_df)
    assert np.array_equal(theirs.fragment_mz_df.to_numpy(), ours.fragment_mz)
    heavy = ours.precursor_df["channel"] == 8
    assert any("HeavyK@K" in m for m in ours.precursor_df["mods"][heavy])


def test_multiplex_library_without_the_input_channel_raises(dimethyl_base):
    from alphadia_torch.library.multiplex import MultiplexLibrary

    with pytest.raises(ValueError, match="no precursors in input channel 3"):
        MultiplexLibrary(_mapping(), input_channel=3)(port_base(dimethyl_base[0]))


# ---------------------------------------------------------------------------
# multiplex_candidates, channel_fdr
# ---------------------------------------------------------------------------
def _confident_psm():  # the JAX unit test's frame
    return pd.DataFrame({
        "elution_group_idx": [0, 1], "channel": [0, 0], "rank": [0, 0], "score": [5.0, 4.0], "qval": [0.001, 0.005],
        "scan_start": [0, 0], "scan_center": [0, 0], "scan_stop": [1, 1], "frame_start": [10, 50],
        "frame_center": [14, 54], "frame_stop": [18, 58],
    })


def _unfiltered_lib(n_groups=3, channels=(0, 4, 8, 12)):
    rows, pid = [], 0
    for eg in range(n_groups):
        for channel in channels:
            rows.append({"precursor_idx": pid, "elution_group_idx": eg, "channel": channel})
            pid += 1
    return pd.DataFrame(rows)


def _seeded_psm(seed, n_groups=300):
    """Several PSMs per elution group and channel, ranks, proba ties."""
    rng = np.random.default_rng(seed)
    n = 3 * n_groups
    return pd.DataFrame({
        "precursor_idx": rng.permutation(n).astype(np.uint32),
        "elution_group_idx": rng.integers(0, n_groups, n).astype(np.uint32),
        "channel": rng.choice(np.array([0, 4, 12], np.uint32), n),
        "rank": rng.integers(0, 3, n).astype(np.uint8),
        "score": rng.normal(size=n).astype(np.float32),
        "proba": np.round(rng.random(n), 2).astype(np.float32),
        "qval": rng.random(n) * 0.02,
        "scan_start": rng.integers(0, 5, n).astype(np.int64), "scan_center": rng.integers(5, 9, n).astype(np.int64),
        "scan_stop": rng.integers(9, 14, n).astype(np.int64), "frame_start": rng.integers(0, 50, n).astype(np.int64),
        "frame_center": rng.integers(50, 60, n).astype(np.int64), "frame_stop": rng.integers(60, 99, n).astype(np.int64),
    })


CANDIDATE_CASES = {
    "jax_unit": lambda: (_confident_psm(), _unfiltered_lib(), 0),
    "no_reference_channel": lambda: (_confident_psm().assign(channel=4), _unfiltered_lib(), 0),
    "seeded_proba": lambda: (_seeded_psm(3), _unfiltered_lib(300, (0, 4, 12)), 0),
    "seeded_score_only": lambda: (_seeded_psm(4).drop(columns="proba"), _unfiltered_lib(300, (0, 4, 12)), 0),
    "every_channel_donates": lambda: (_seeded_psm(5), _unfiltered_lib(300, (0, 4, 12)), -1),
}


@pytest.mark.parametrize("case", sorted(CANDIDATE_CASES))
def test_multiplex_candidates_match_jax(case):
    from alphadia_torch.workflow.peptidecentric.multiplexing_handler import multiplex_candidates
    from alphadia_tpu.workflow.peptidecentric.multiplexing_handler import multiplex_candidates as jax_candidates

    psm, lib, reference = CANDIDATE_CASES[case]()
    theirs = jax_candidates(psm, lib, reference)
    ours = multiplex_candidates(frame_from_pandas(psm), frame_from_pandas(lib), reference)
    if case == "no_reference_channel":
        assert len(theirs) == 0 and ours == {}
        return
    assert_same(theirs, ours, case)
    if case == "jax_unit":
        assert len(ours["channel"]) == 8 and set(ours["channel"].tolist()) == {0, 4, 8, 12}
        assert (ours["frame_center"][ours["elution_group_idx"] == 0] == 14).all()


def _channel_rows(seed, degraded=False):  # the JAX unit tests' frames
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(400):
        for channel in (4, 8, 12):
            if channel == 12:
                proba = rng.uniform(0.3, 1.0)
            elif channel == 4 or not degraded:
                proba = rng.uniform(0.0, 0.3 if degraded else 0.4)
            else:
                proba = rng.uniform(0.2, 0.9)
            rows.append({"elution_group_idx": i, "channel": channel, "precursor_idx": i * 10 + channel, "proba": proba})
    return pd.DataFrame(rows)


FDR_CASES = {
    "global": lambda: (_channel_rows(0), False),
    "channel_wise": lambda: (_channel_rows(1, degraded=True), True),
    "seeded_global": lambda: (_seeded_psm(6).drop(columns="qval"), False),
    "seeded_channel_wise": lambda: (_seeded_psm(7).drop(columns="qval"), True),
}


@pytest.mark.parametrize("case", sorted(FDR_CASES))
def test_channel_fdr_matches_jax(case):
    from alphadia_torch.workflow.peptidecentric.multiplexing_handler import channel_fdr
    from alphadia_tpu.workflow.peptidecentric.multiplexing_handler import channel_fdr as jax_channel_fdr

    psm, wise = FDR_CASES[case]()
    targets = [4, 8] if "seeded" not in case else [0, 4]
    theirs = jax_channel_fdr(psm, decoy_channel=12, target_channels=targets, channel_wise=wise)
    ours = channel_fdr(frame_from_pandas(psm), decoy_channel=12, target_channels=targets, channel_wise=wise)
    assert_same(theirs, ours, case)
    if wise:
        assert (ours["qval"][ours["channel"] == 12] == 1.0).all()
    if case == "global":
        good = (ours["qval"] <= 0.05) & (ours["channel"] != 12)
        assert good.sum() > 400  # the JAX unit test's assertion


# ---------------------------------------------------------------------------
# the multiplexed search and the handler on a small dimethyl world
# ---------------------------------------------------------------------------
SMALL_RUN = dict(n_windows=6, n_cycles=300, noise_peaks_per_spectrum=30, seed=9, detectable_fraction=1.0)


@pytest.fixture(scope="module")
def dimethyl_world(tmp_path_factory):
    """The e2e test's world: the 4-protein FASTA with fixed light dimethyl,
    channels 0 and 4 planted (4 at half intensity) as an mzML, the base
    library as HDF (the port's writer), the search config."""
    from alphadia_torch.library.flatten import FlattenLibrary, InitFlatColumns
    from alphadia_torch.library.multiplex import MultiplexLibrary
    from alphadia_torch.testing.mzml_writer import write_mzml
    from alphadia_torch.testing.synthetic import SyntheticConfig, make_run_from_library
    from alphadia_torch.library.digest import digest_fasta
    from alphadia_torch.library.harmonize import IsotopeGenerator, PrecursorInitializer
    from torch_workflow_worlds import MULTIPLEX_DIGEST, MULTIPLEX_MAPPING, MULTIPLEX_OVERRIDES, _float64_prediction

    tmp = tmp_path_factory.mktemp("dimethyl")
    fasta = tmp / "t.fasta"
    fasta.write_text(FASTA)

    base = digest_fasta([str(fasta)], missed_cleavages=0, **MULTIPLEX_DIGEST)
    base = IsotopeGenerator()(_float64_prediction()(PrecursorInitializer()(base)))
    flat = InitFlatColumns()(FlattenLibrary()(MultiplexLibrary(MULTIPLEX_MAPPING[:2])(base.copy())))
    frag = dict(flat.fragment_df)
    counts = flat.precursor_df["flat_frag_stop_idx"].astype(np.int64) - flat.precursor_df["flat_frag_start_idx"]
    scale = np.where(flat.precursor_df["channel"] == 4, np.float32(0.5), np.float32(1.0))
    frag["intensity"] = (frag["intensity"] * np.repeat(scale, counts)).astype(np.float32)
    raw = tmp / "run.mzML"
    write_mzml(raw, make_run_from_library(flat.precursor_df, frag, SyntheticConfig(**SMALL_RUN)))
    lib = tmp / "base.hdf"
    base.save_hdf(lib)
    cfg = json.loads(json.dumps(MULTIPLEX_OVERRIDES))
    cfg["general"]["random_state"] = 4
    cfg.update(library_path=str(lib), raw_paths=[str(raw)])
    return tmp, cfg


def test_multiplexed_library_of_the_step_matches_jax(dimethyl_world):
    """``SearchStep.load_library`` with ``library_multiplexing``: JAX's
    channel library (decoys, flattened), the port's alike."""
    import alphadia_torch.search_step as port_step
    import alphadia_tpu.search_step as jax_step

    tmp, cfg = dimethyl_world
    theirs = jax_step.SearchStep(str(tmp / "jax_lib"), config=cfg).load_library()
    ours = port_step.SearchStep(str(tmp / "port_lib"), config=cfg, device="cpu").load_library()
    channels = sorted(set(ours.precursor_df["channel"].tolist()))
    assert channels == [0, 4, 12]
    for name in ("precursor_df", "fragment_df"):
        a, b = getattr(theirs, name), getattr(ours, name)
        assert list(a.columns) == list(b)
        for c in a.columns:
            x, y = a[c].to_numpy(), np.asarray(b[c])
            if x.dtype == object:
                assert [str(v) for v in x] == [str(v) for v in y], (name, c)
            elif c in ("rt_library", "mobility_library", "intensity"):
                # predicted again by each package's models: flax's float32 products against torch's, the
                # prediction tests' tolerance
                np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-6, err_msg=c)
            else:
                assert x.dtype == y.dtype and np.array_equal(x, y), (name, c)


def test_multiplexed_search_writes_channels_and_the_handler_requantifies(dimethyl_world):
    """The port's step on the small world: ``precursors.parquet`` carries
    ``precursor.channel`` (both planted channels, few decoy-channel IDs);
    then ``requantify`` on a workflow of the same search: channel PSMs with
    q-values, the decoy channel at the null. JAX's handler, on its own
    workflow, asks for a fragment ``mz_calibrated`` column the unfiltered
    fragments lack (the port calibrates them: ROADMAP §3)."""
    import alphadia_torch.search_step as port_step
    from alphadia_torch.config import load_default_config
    from alphadia_torch.library.speclib import SpecLibFlat
    from alphadia_torch.utils.parquet import read_parquet
    from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow

    tmp, cfg = dimethyl_world
    step = port_step.SearchStep(str(tmp / "port_out"), config=cfg, device="cpu")
    step.run()
    prec = read_parquet(tmp / "port_out" / "precursors.parquet")
    channel = np.asarray(prec["precursor.channel"]).astype(int)
    n0, n4, n12 = ((channel == c).sum() for c in (0, 4, 12))
    assert n0 > 15 and n4 > 0.5 * n0 and n12 <= max(1, 0.05 * n0), (n0, n4, n12)

    config = load_default_config()
    config.update_layer({**cfg, "output_directory": str(tmp / "wf")}, name="test")
    wf = PeptideCentricWorkflow("run", config, random_state=4, device="cpu")
    wf.load(cfg["raw_paths"][0], SpecLibFlat(step.spectral_library.precursor_df, step.spectral_library.fragment_df))
    wf.search_parameter_optimization()
    psm, _ = wf.extraction()
    assert wf.calibration_manager.groups["fragment"]["mz"].is_fitted
    out, frags = wf.requantify(psm)
    q, ch = out["qval"], out["channel"]
    assert set(np.unique(ch).tolist()) <= {0, 4, 12} and len(frags["precursor_idx"]) > 0
    assert ((q <= 0.01) & (ch == 0)).sum() > 10 and ((q <= 0.01) & (ch == 4)).sum() > 10
    assert ((q <= 0.01) & (ch == 12)).sum() <= max(1, 0.05 * ((q <= 0.01) & (ch == 0)).sum())


def test_jax_requantify_lacks_the_fragment_calibration(dimethyl_world):
    """The reference's handler on its own workflow of the same search: its
    scoring asks for the fragments' ``mz_calibrated``, which the unfiltered
    fragment table lacks once the fragment calibration is fitted; the
    port's handler calibrates them (the test above)."""
    from alphadia_tpu.config import load_default_config as jax_load_default_config
    from alphadia_tpu.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow as JaxWorkflow

    import alphadia_tpu.search_step as jax_step

    tmp, cfg = dimethyl_world
    lib = jax_step.SearchStep(str(tmp / "jax_wf_lib"), config=cfg).load_library()
    config = jax_load_default_config()
    config.update_layer({**cfg, "output_directory": str(tmp / "jax_wf")}, name="test")
    wf = JaxWorkflow("run", config, random_state=4)
    wf.load(cfg["raw_paths"][0], lib)
    wf.search_parameter_optimization()
    psm, _ = wf.extraction()
    assert wf.calibration_manager.groups["fragment"]["mz"].is_fitted
    with pytest.raises(KeyError, match="mz_calibrated"):
        wf.requantify(psm)
