"""The port's ``SearchPlan`` against the JAX package's, on the CPU (the
cases of ``tests/unit/test_search_plan.py``, ``run_step`` recorded so that
no search runs):

- the plain plan runs one step in the output directory with no extras, in
  both packages; the CLI layer decides whether a later step is enabled;
- the MBR plan (enabled by the config or the CLI layer) runs the library
  step and then the MBR step with the directories and extras of JAX's
  (the library step's tolerances from its ``stat.tsv``, the flat
  ``speclib.mbr.hdf`` where it was written);
- the transfer step (alone or before the library and MBR steps) runs first
  in ``transfer/`` and hands every later step its tolerances and, where it
  wrote ``models.pkl``, its model directory, as JAX's plan does;
- ``_get_optimized_values_config`` gives JAX's result on the same
  ``stat.tsv`` (medians, a NaN column, no file); ``_merge`` equals JAX's;
- ``SearchStep.run`` ends with ``SearchPlanOutput.build`` over every raw
  path's quant folder, after a ``fail_fast`` error is raised.
"""

import numpy as np
import pandas as pd
import pytest

import alphadia_torch.search_step as port_step
from alphadia_torch.search_plan import TRANSFER_EXTRA, SearchPlan, _merge
from alphadia_torch.search_step import SearchStep
from alphadia_tpu.search_plan import SearchPlan as JaxSearchPlan
from alphadia_tpu.search_plan import _merge as jax_merge

pytest_plugins = ("torch_port_plugin",)


@pytest.fixture()
def recorded(monkeypatch):
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(SearchPlan, "run_step", lambda self, d, e: calls["port"].append((str(d), e)))
    monkeypatch.setattr(JaxSearchPlan, "run_step", lambda self, d, e: calls["jax"].append((str(d), e)))
    return calls


PLAIN = {
    "no_config": ({}, {}),
    "cli_disables_transfer": ({"general": {"transfer_step_enabled": True}}, {"general": {"transfer_step_enabled": False}}),
    "cli_disables_mbr": ({"general": {"mbr_step_enabled": True}}, {"general": {"mbr_step_enabled": False}}),
}


@pytest.mark.parametrize("case", PLAIN)
def test_plain_plan_runs_one_step_as_jax(tmp_path, recorded, case):
    config, cli = PLAIN[case]
    JaxSearchPlan(str(tmp_path), config=config, cli_config=cli).run_plan()
    SearchPlan(str(tmp_path), config=config, cli_config=cli).run_plan()
    assert recorded["port"] == recorded["jax"] == [(str(tmp_path), {})]


MBR = {
    "mbr": ({"general": {"mbr_step_enabled": True}}, {}, ()),
    "cli_enables_mbr": ({}, {"general": {"mbr_step_enabled": True}}, ()),
    "library_written": ({"general": {"mbr_step_enabled": True}}, {}, ("speclib.mbr.hdf",)),
    "tolerances_and_library": ({}, {"general": {"mbr_step_enabled": True}}, ("speclib.mbr.hdf", "stat.tsv")),
}


@pytest.mark.parametrize("case", MBR)
def test_mbr_plan_runs_the_library_and_mbr_steps_as_jax(tmp_path, monkeypatch, case):
    """Each package's ``run_step`` recorded; the library step's outputs
    that the MBR step reads (``speclib.mbr.hdf``, ``stat.tsv``) written by
    the recording where the case has them."""
    config, cli, outputs = MBR[case]
    calls = {"port": [], "jax": []}

    def recorder(key):
        def run_step(self, d, e):
            calls[key].append((str(d), e))
            if str(d).endswith("library"):
                d.mkdir(parents=True, exist_ok=True)
                for name in outputs:
                    if name == "stat.tsv":
                        pd.DataFrame(STATS["medians"]).to_csv(d / name, sep="\t", index=False)
                    else:
                        (d / name).write_bytes(b"")

        return run_step

    monkeypatch.setattr(SearchPlan, "run_step", recorder("port"))
    monkeypatch.setattr(JaxSearchPlan, "run_step", recorder("jax"))
    JaxSearchPlan(str(tmp_path / "jax"), config=config, cli_config=cli).run_plan()
    SearchPlan(str(tmp_path / "port"), config=config, cli_config=cli).run_plan()
    port = [(d.replace("/port", "/jax"), repr(e).replace("/port/", "/jax/")) for d, e in calls["port"]]
    assert port == [(d, repr(e)) for d, e in calls["jax"]]
    (lib_dir, lib_extra), (mbr_dir, mbr_extra) = calls["port"]
    assert lib_dir == str(tmp_path / "port" / "library") and lib_extra == {"general": {"save_mbr_library": True}}
    assert mbr_dir == str(tmp_path / "port")
    assert mbr_extra["search"]["target_num_candidates"] == 5 and mbr_extra["fdr"]["inference_strategy"] == "library"
    assert ("library_path" in mbr_extra) == ("speclib.mbr.hdf" in outputs)
    assert ("target_ms2_tolerance" in mbr_extra["search"]) == ("stat.tsv" in outputs)


TRANSFER = {
    "transfer": ({"general": {"transfer_step_enabled": True}}, {}, ("stat.tsv", "models.pkl")),
    "both": ({"general": {"transfer_step_enabled": True, "mbr_step_enabled": True}}, {},
             ("stat.tsv", "models.pkl", "speclib.mbr.hdf")),
    "transfer_without_models": ({}, {"general": {"transfer_step_enabled": True}}, ("stat.tsv",)),
    "both_without_outputs": ({"general": {"transfer_step_enabled": True}}, {"general": {"mbr_step_enabled": True}}, ()),
}


@pytest.mark.parametrize("case", TRANSFER)
def test_transfer_plan_forwards_its_models_and_tolerances_as_jax(tmp_path, monkeypatch, case):
    """The transfer step first, in ``transfer/`` with ``TRANSFER_EXTRA``;
    its optimized tolerances and, where it wrote ``models.pkl``, its model
    directory as ``peptdeep_model_path`` go to every later step, the MBR
    step's merged with the library step's tolerances: each package's
    ``run_step`` recorded, the steps' outputs written by the recording
    where the case has them."""
    config, cli, outputs = TRANSFER[case]
    calls = {"port": [], "jax": []}

    def recorder(key):
        def run_step(self, d, e):
            calls[key].append((str(d), e))
            d.mkdir(parents=True, exist_ok=True)
            for name in outputs:
                if name == "stat.tsv":
                    stats = STATS["medians"] if d.name == "transfer" else STATS["even_count"]
                    pd.DataFrame(stats).to_csv(d / name, sep="\t", index=False)
                elif name == "models.pkl" and d.name == "transfer":
                    (d / "peptdeep.transfer").mkdir(exist_ok=True)
                    (d / "peptdeep.transfer" / name).write_bytes(b"")
                elif name == "speclib.mbr.hdf" and d.name == "library":
                    (d / name).write_bytes(b"")

        return run_step

    monkeypatch.setattr(SearchPlan, "run_step", recorder("port"))
    monkeypatch.setattr(JaxSearchPlan, "run_step", recorder("jax"))
    JaxSearchPlan(str(tmp_path / "jax"), config=config, cli_config=cli).run_plan()
    SearchPlan(str(tmp_path / "port"), config=config, cli_config=cli).run_plan()
    port = [(d.replace("/port", "/jax"), repr(e).replace("/port/", "/jax/")) for d, e in calls["port"]]
    assert port == [(d, repr(e)) for d, e in calls["jax"]]
    steps = [d for d, _ in calls["port"]]
    mbr = "mbr_step_enabled" in repr((config, cli))
    want = [tmp_path / "port" / "transfer", *([tmp_path / "port" / "library"] if mbr else []), tmp_path / "port"]
    assert steps == [str(d) for d in want]
    assert calls["port"][0][1] == TRANSFER_EXTRA
    for _, extra in calls["port"][1:]:
        model = extra.get("library_prediction", {}).get("peptdeep_model_path")
        assert (model == str(tmp_path / "port" / "transfer" / "peptdeep.transfer")) == ("models.pkl" in outputs)
        assert ("target_ms2_tolerance" in extra.get("search", {})) == ("stat.tsv" in outputs)


STATS = {
    "medians": {"optimization.ms1_error": [4.0, 6.0, 5.0], "optimization.ms2_error": [8.0, 12.0, 10.0]},
    "even_count": {"optimization.ms1_error": [4.0, 6.5], "optimization.ms2_error": [8.25, 12.0]},
    "nan_column": {"optimization.ms1_error": [float("nan")], "optimization.ms2_error": [7.0]},
    "partial_nan": {"optimization.ms1_error": [float("nan"), 3.0], "optimization.ms2_error": [7.0, float("nan")]},
    "other_columns": {"run": ["a", "b"], "precursors": [10, 20]},
    "no_file": None,
}


@pytest.mark.parametrize("case", STATS)
def test_optimized_values_match_jax(tmp_path, case):
    if STATS[case] is not None:
        pd.DataFrame(STATS[case]).to_csv(tmp_path / "stat.tsv", sep="\t", index=False)
    want = JaxSearchPlan._get_optimized_values_config(tmp_path)
    assert SearchPlan._get_optimized_values_config(tmp_path) == want
    if case == "medians":
        assert want == {"search": {"target_ms1_tolerance": 5.0, "target_ms2_tolerance": 10.0}}


def test_merge_matches_jax():
    layers = (
        {"a": {"b": 1, "c": [1, 2]}, "d": 1},
        {"a": {"b": 2, "e": {"f": 3}}, "d": {"x": 1}},
        {"a": {"e": {"g": 4}}, "h": None},
    )
    assert _merge(*layers) == jax_merge(*layers)


def test_search_step_ends_with_the_cross_run_outputs(tmp_path, monkeypatch):
    monkeypatch.setattr(SearchStep, "load_library", lambda self: "library")
    processed, built = [], []
    monkeypatch.setattr(SearchStep, "_process_raw_file", lambda self, path, name, q: processed.append(name))

    class Output:
        def __init__(self, config, folder, device=None):
            self.folder, self.device = folder, device

        def build(self, folders, library):
            built.append(([str(f) for f in folders], library, str(self.folder), str(self.device)))

    monkeypatch.setattr(port_step, "SearchPlanOutput", Output)
    SearchStep(str(tmp_path), config={"raw_paths": ["x/a.mzML", "y/b.mzML"]}, device="cpu").run()
    assert processed == ["a", "b"]
    assert built == [([str(tmp_path / "quant" / "a"), str(tmp_path / "quant" / "b")], "library", str(tmp_path), "cpu")]

    # fail_fast: the error comes before the aggregation
    def boom(self, path, name, q):
        raise RuntimeError("disk on fire")

    built.clear()
    monkeypatch.setattr(SearchStep, "_process_raw_file", boom)
    with pytest.raises(RuntimeError, match="disk on fire"):
        SearchStep(str(tmp_path / "ff"), config={"raw_paths": ["a.mzML"], "general": {"fail_fast": True}},
                   device="cpu").run()
    assert built == []
    # without fail_fast the failed run is collected and the rest aggregated
    step = SearchStep(str(tmp_path / "nf"), config={"raw_paths": ["a.mzML"]}, device="cpu")
    step.run()
    assert [e[0] for e in step.errors] == ["a"] and len(built) == 1


def test_mbr_library_is_built_and_its_write_refused(tmp_path, caplog):
    """The MBR library of a precursor table: kept elution groups, RT from
    the PSMs, protein groups; the output writes it as ``speclib.mbr.hdf``,
    which the port and the JAX package read back equal, and where the write
    is refused (a directory in the file's place) it logs JAX's warning."""
    import logging

    from alphadia_torch.library.loader import load_speclib_hdf
    from alphadia_tpu.library.speclib import SpecLibFlat as JaxSpecLibFlat

    from alphadia_torch.config import load_default_config
    from alphadia_torch.library.speclib import SpecLibFlat
    from alphadia_torch.outputs.mbr import MbrLibraryBuilder
    from alphadia_torch.outputs.search_plan_output import SearchPlanOutput

    prec = {
        "precursor_idx": np.arange(4, dtype=np.uint32), "elution_group_idx": np.array([0, 0, 1, 2], np.uint32),
        "decoy": np.array([0, 1, 0, 0], np.uint8), "rt_library": np.float32([10, 10, 20, 30]),
        "mod_seq_charge_hash": np.array([5, 6, 7, 8], np.uint64), "proteins": np.array(["A", "A", "B", "C"], object),
        "flat_frag_start_idx": np.array([0, 2, 4, 6], np.uint32), "flat_frag_stop_idx": np.array([2, 4, 6, 8], np.uint32),
    }
    frag = {"mz_library": np.arange(8, dtype=np.float32)}
    psm = {
        "precursor_idx": np.array([0, 2, 0], np.uint32), "elution_group_idx": np.array([0, 1, 0], np.uint32),
        "decoy": np.zeros(3, np.uint8), "qval": np.array([0.0, 0.5, 0.001]), "rt_observed": np.float32([11, 21, 13]),
        "mod_seq_charge_hash": np.array([5, 7, 5], np.uint64), "pg": np.array(["A;X", "B", "A;X"], object),
    }
    lib = MbrLibraryBuilder(fdr=0.01, keep_decoys=False)(psm, SpecLibFlat(prec, frag))
    assert lib.precursor_df["precursor_idx"].tolist() == [0]
    assert lib.precursor_df["rt_library"].tolist() == [12.0]
    assert lib.precursor_df["proteins"].tolist() == ["A;X"]
    assert lib.fragment_df["mz_library"].tolist() == [0.0, 1.0]
    kept = MbrLibraryBuilder(fdr=0.01, keep_decoys=True)(psm, SpecLibFlat(prec, frag))
    assert kept.precursor_df["precursor_idx"].tolist() == [0, 1]

    out = SearchPlanOutput(load_default_config(), tmp_path)
    with caplog.at_level(logging.WARNING):
        out._build_mbr_library(psm, SpecLibFlat(prec, frag))
    assert not [r for r in caplog.records if "could not build MBR library" in r.message]
    back, theirs = load_speclib_hdf(tmp_path / "speclib.mbr.hdf"), JaxSpecLibFlat.load_hdf(tmp_path / "speclib.mbr.hdf")
    for frame, want, jax_frame in ((back.precursor_df, lib.precursor_df, theirs.precursor_df),
                                   (back.fragment_df, lib.fragment_df, theirs.fragment_df)):
        assert list(frame) == list(want) == list(jax_frame.columns)
        for c in want:
            assert frame[c].dtype == jax_frame[c].to_numpy().dtype or frame[c].dtype == object
            assert np.asarray(frame[c]).tolist() == np.asarray(want[c]).tolist() == jax_frame[c].tolist()

    blocked = SearchPlanOutput(load_default_config(), tmp_path / "blocked")
    (tmp_path / "blocked" / "speclib.mbr.hdf").mkdir(parents=True)
    with caplog.at_level(logging.WARNING):
        blocked._build_mbr_library(psm, SpecLibFlat(prec, frag))
    warnings = [r.message for r in caplog.records if "could not build MBR library" in r.message]
    assert len(warnings) == 1
