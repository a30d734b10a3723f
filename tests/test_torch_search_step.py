"""``SearchStep``: the port's against the JAX package's.

- The port's versions of ``tests/unit/test_search_step.py``: config layering
  and ``frozen_config.yaml`` (``yaml.safe_load`` of the port's file equals
  the JAX package's), ``reuse_quant``, errors collected without
  ``fail_fast``, ``fail_fast`` raising, a shared quant directory.
- A process that cannot join its group raises before any search;
  ``general.profile_directory``
  writes a trace a raw file, and ``transfer_learning.enabled`` runs.
- ``general.save_library`` / ``save_flat_library`` write ``speclib.hdf`` /
  ``speclib.flat.hdf`` that both packages read equal to each other's; a
  base or flat HDF library as ``library_path`` gives JAX's flat library.
- End to end on the 400-peptide, 6-window 3D world of
  ``tests/torch_workflow_worlds.py`` written as mzML and a TSV transition
  list: JAX ``SearchStep.run()`` (its cross-run aggregation left out) and
  the port's ``SearchStep(..., device="cpu").run()``. Held: the flat library
  after ``load_library`` equal (names, order, dtypes, values), the per-run
  ``psm.parquet`` with JAX's column names and pyarrow types, the same steps
  per optimizer, final tolerances within 5%, the target IDs at 1% FDR with
  a Jaccard overlap >= 0.95, and the port's parquet files read back by its
  own reader equal to pyarrow's reading.

Run as a script it runs both steps on a quarter of a ``chip_smoke.py``
phase-[8] world (3 isolation windows instead of 12, the same density a
window, the default config, random state 0 unless ``--random-state`` says
otherwise) and prints each one's steps, final tolerances and identified
and false shares at 1% FDR, which phase [8] gates against:

    PYTHONPATH=. python tests/test_torch_search_step.py --peptides 1500 --windows 3 [--random-state N]
    PYTHONPATH=. python tests/test_torch_search_step.py --peptides 6250 --windows 3 --mobility --batch-size 2000 [--random-state N]
"""

import argparse

import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest
import yaml

import alphadia_torch.search_step as port_module
import alphadia_tpu.search_step as jax_module
from alphadia_torch.convert import frame_from_pandas
from alphadia_torch.exceptions import BusinessError, NoLibraryAvailableError, NoPsmFoundError
from alphadia_torch.library.speclib import SpecLibFlat
from alphadia_torch.search_step import SearchStep
from alphadia_torch.utils.parquet import read_parquet, write_parquet
from alphadia_torch.workflow.base import QUANT_FOLDER_NAME
from torch_workflow_worlds import TOLERANCES, WORLDS, record_optimizers, search_id_shares, steps_per_optimizer
from torch_workflow_worlds import target_ids, write_search_inputs

pytest_plugins = ("torch_port_plugin",)

TOL_REL = 0.05
JACCARD_MIN = 0.95


def step(tmp_path, **kw):
    return SearchStep(str(tmp_path), device="cpu", **kw)


@pytest.fixture()
def light_step(monkeypatch):
    """No library build and no cross-run build (as the JAX unit tests'
    fixture): run() is the per-file loop."""
    monkeypatch.setattr(SearchStep, "load_library", lambda self: None)

    class NoOutput:
        def __init__(self, *a):
            pass

        def build(self, *a):
            pass

    monkeypatch.setattr(port_module, "SearchPlanOutput", NoOutput)


# ---------------------------------------------------------------------------
# the JAX unit tests' semantics
# ---------------------------------------------------------------------------
def test_config_layering_frozen(tmp_path, light_step):
    layers = dict(
        config={"search": {"target_ms1_tolerance": 7}, "output_directory": str(tmp_path / "out")},
        cli_config={"search": {"target_ms2_tolerance": 9}},
        extra_config={"search": {"target_rt_tolerance": 44}, "custom_modifications": [{"name": "FrozenConfigTestMod@K", "composition": "H(2)C(1)"}]},
    )
    s = step(tmp_path / "port", **layers)
    jax_module.SearchStep(str(tmp_path / "jax"), **layers)
    ours = yaml.safe_load((tmp_path / "port" / "frozen_config.yaml").read_text())
    theirs = yaml.safe_load((tmp_path / "jax" / "frozen_config.yaml").read_text())
    assert ours == theirs
    assert list(ours) == list(theirs)
    assert ours["search"]["target_ms1_tolerance"] == 7
    assert ours["search"]["target_ms2_tolerance"] == 9
    assert ours["search"]["target_rt_tolerance"] == 44
    assert s.config["output_directory"] == str(tmp_path / "out")
    assert step(tmp_path / "bare").config["output_directory"] == str(tmp_path / "bare")


def test_per_file_seeds_follow_jax(tmp_path, light_step):
    cfg = {"general": {"random_state": 123}}
    ours = step(tmp_path / "p", config=cfg)._np_rng.integers(0, 2**31, 3)
    theirs = jax_module.SearchStep(str(tmp_path / "j"), config=cfg)._np_rng.integers(0, 2**31, 3)
    assert np.array_equal(ours, theirs)


def test_reuse_quant_skips_processed_runs(tmp_path, light_step, monkeypatch):
    quant = tmp_path / QUANT_FOLDER_NAME / "runA"
    quant.mkdir(parents=True)
    write_parquet({"x": np.array([1])}, quant / "psm.parquet")
    processed = []
    monkeypatch.setattr(SearchStep, "_process_raw_file", lambda self, p, n, q: processed.append(n))
    step(tmp_path, config={"raw_paths": ["/data/runA.mzML", "/data/runB.mzML"], "general": {"reuse_quant": True}}).run()
    assert processed == ["runB"]


def test_a_run_after_a_reused_file_keeps_its_seed(tmp_path, light_step, monkeypatch):
    """File i takes the i-th draw of the step's generator over the whole
    list of raw paths, searched or not: a reused run shifts no later run's
    seed (the JAX package draws once a searched file, so there it would).
    With nothing reused the draws are JAX's, one a file in order."""
    paths = ["/data/runA.mzML", "/data/runB.mzML", "/data/runC.mzML"]
    cfg = {"raw_paths": paths, "general": {"random_state": 123, "reuse_quant": True}}

    def seeds_of(folder):
        seen = {}
        monkeypatch.setattr(SearchStep, "_process_raw_file", lambda self, p, n, q: seen.update({n: self._file_seeds[p]}))
        step(folder, config=cfg).run()
        return seen

    every = seeds_of(tmp_path / "all")
    rng = jax_module.SearchStep(str(tmp_path / "j"), config=cfg)._np_rng
    assert every == {n: int(rng.integers(0, 2**31)) for n in ("runA", "runB", "runC")}
    quant = tmp_path / "reuse" / QUANT_FOLDER_NAME / "runA"
    quant.mkdir(parents=True)
    write_parquet({"x": np.array([1])}, quant / "psm.parquet")
    assert seeds_of(tmp_path / "reuse") == {"runB": every["runB"], "runC": every["runC"]}


def test_errors_collected_without_fail_fast(tmp_path, light_step, monkeypatch):
    def boom(self, path, name, q):
        raise BusinessError(f"bad {name}")

    monkeypatch.setattr(SearchStep, "_process_raw_file", boom)
    s = step(tmp_path, config={"raw_paths": ["/a/r1.mzML", "/a/r2.mzML"]})
    s.run()
    assert [n for n, _ in s.errors] == ["r1", "r2"]
    assert {code for _, code in s.errors} == {"BUSINESS_ERROR"}


def test_fail_fast_raises(tmp_path, light_step, monkeypatch):
    def boom(self, path, name, q):
        raise BusinessError("nope")

    monkeypatch.setattr(SearchStep, "_process_raw_file", boom)
    s = step(tmp_path, config={"raw_paths": ["/a/r1.mzML", "/a/r2.mzML"], "general": {"fail_fast": True}})
    with pytest.raises(BusinessError):
        s.run()
    assert [n for n, _ in s.errors] == ["r1"]


def test_shared_quant_directory(tmp_path, light_step, monkeypatch):
    seen = []
    monkeypatch.setattr(SearchStep, "_process_raw_file", lambda self, p, n, q: seen.append(str(q)))
    shared = tmp_path / "sharedquant"
    step(tmp_path / "out", config={"raw_paths": ["/a/r1.mzML"], "quant_directory": str(shared)}).run()
    assert seen == [str(shared)]


def test_a_raw_file_that_fails_is_collected(tmp_path, monkeypatch):
    """A raw file in a format without a reader fails on its own; the error
    names the formats that read. With no run left, the cross-run outputs
    find no PSMs (``NoPsmFoundError``, as in the JAX package)."""
    monkeypatch.setattr(SearchStep, "load_library", lambda self: SpecLibFlat({}, {}))
    s = step(tmp_path, config={"raw_paths": [str(tmp_path / "run.raw")]})
    with pytest.raises(NoPsmFoundError):
        s.run()
    assert len(s.errors) == 1 and "Unsupported" in s.errors[0][1] and ".hdf (alphaRaw)" in s.errors[0][1]


# ---------------------------------------------------------------------------
# what comes with later slices
# ---------------------------------------------------------------------------
LATER = {
    "profile_directory": {"general": {"profile_directory": "prof"}},
    "transfer_library": {"transfer_library": {"enabled": True}, "transfer_learning": {"enabled": True, "epochs": 2}},
}


@pytest.fixture(scope="module")
def small_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("inputs")
    return write_search_inputs(tmp, WORLDS["3d"]["world"])


@pytest.mark.parametrize("case", sorted(LATER))
def test_profile_directory_and_transfer_learning_run(tmp_path, small_inputs, case):
    """``general.profile_directory`` writes a trace of the raw file's three
    workflow stages, named by their phases; ``transfer_learning.enabled``
    searches, writes the transfer library's run files and, where a library
    passed the MS2 QC, the fine-tuned models with their stats."""
    cfg = {"library_path": str(small_inputs[1]), "raw_paths": [str(small_inputs[0])], **LATER[case]}
    if case == "profile_directory":
        cfg["general"] = {"profile_directory": str(tmp_path / "prof")}
    s = step(tmp_path, config=cfg)
    s.run()
    run = small_inputs[0].stem
    assert not s.errors and (tmp_path / QUANT_FOLDER_NAME / run / "psm.parquet").exists()
    if case == "profile_directory":
        trace = (tmp_path / "prof" / run / "trace.json").read_text()
        for phase in ("load", "optimization", "extraction"):
            assert f'"alphadia_torch.{phase}"' in trace
        return
    assert (tmp_path / QUANT_FOLDER_NAME / run / "frag.transfer.parquet").exists()
    library = (tmp_path / "speclib.transfer.parquet").exists()
    assert (tmp_path / "peptdeep.transfer" / "models.pkl").exists() == library
    assert (tmp_path / "stats.transfer.tsv").exists() == library


def assert_same_frames(jax_frame, port_frame, where=""):
    """A pandas frame of the JAX package and a column dict of the port:
    the same names in order, dtypes and values (text as ``str``)."""
    assert list(jax_frame.columns) == list(port_frame), where
    for c in jax_frame.columns:
        a, b = jax_frame[c].to_numpy(), np.asarray(port_frame[c])
        if a.dtype == object or a.dtype.kind == "U":
            assert b.dtype == object and [str(x) for x in a] == list(b), (where, c)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (where, c)


def assert_same_flat(jax_lib, port_lib, where=""):
    assert_same_frames(jax_lib.precursor_df, port_lib.precursor_df, f"{where} precursor_df")
    assert_same_frames(jax_lib.fragment_df, port_lib.fragment_df, f"{where} fragment_df")


def assert_same_base(jax_lib, port_lib, where=""):
    assert_same_frames(jax_lib.precursor_df, port_lib.precursor_df, f"{where} precursor_df")
    for frame, matrix in ((jax_lib.fragment_mz_df, port_lib.fragment_mz),
                          (jax_lib.fragment_intensity_df, port_lib.fragment_intensity)):
        assert list(frame.columns) == port_lib.charged_frag_types, where
        assert frame.to_numpy().dtype == matrix.dtype and np.array_equal(frame.to_numpy(), matrix), where


def _load_library(tmp_path, who, cfg):
    if who == "jax":
        return jax_module.SearchStep(str(tmp_path / who), config=cfg).load_library()
    return step(tmp_path / who, config=cfg).load_library()


@pytest.mark.parametrize("key,name", [("save_library", "speclib.hdf"), ("save_flat_library", "speclib.flat.hdf")])
def test_saved_libraries_are_read_equal_by_both_packages(tmp_path, small_inputs, key, name):
    """Each package's ``load_library`` with ``general.<key>`` writes
    ``<name>``; each file is read by both packages, equal to the other's."""
    from alphadia_torch.library.loader import load_speclib_hdf
    from alphadia_tpu.library.loader import load_speclib_hdf as jax_load_speclib_hdf

    cfg = {"library_path": str(small_inputs[1]), "general": {key: True}}
    libs = {who: _load_library(tmp_path, who, cfg) for who in ("jax", "port")}
    assert_same_flat(libs["jax"], libs["port"], "in memory")
    check = assert_same_base if key == "save_library" else assert_same_flat
    for writer in ("jax", "port"):
        path = tmp_path / writer / name
        ours, theirs = load_speclib_hdf(path), jax_load_speclib_hdf(path)
        check(theirs, ours, f"{writer}'s {name}")
        check(jax_load_speclib_hdf(tmp_path / "jax" / name), ours, f"{writer}'s {name} against JAX's")
    if key == "save_flat_library":
        assert_same_flat(jax_load_speclib_hdf(tmp_path / "port" / name), libs["port"], "the port's file")


@pytest.mark.parametrize("kind", ["base", "flat_without_decoys"])
def test_hdf_library_inputs_give_jax_flat_library(tmp_path, small_inputs, kind):
    """A base library in HDF goes through harmonize, decoys and flattening;
    a flat one without decoys (the MBR library's form) gets its decoys made
    anew; either equal to JAX's from the same file."""
    cfg = {"library_path": str(small_inputs[1]), "general": {"save_library": True, "save_flat_library": True}}
    _load_library(tmp_path / "make", "jax", cfg)
    path = tmp_path / "make" / "jax" / "speclib.hdf"
    if kind == "flat_without_decoys":
        from alphadia_torch.library.loader import load_speclib_hdf
        from alphadia_torch.workflow.optimizers.optimization_lock import subset_flat_library

        flat = load_speclib_hdf(tmp_path / "make" / "jax" / "speclib.flat.hdf")
        targets = subset_flat_library(flat.precursor_df, flat.fragment_df, np.asarray(flat.precursor_df["decoy"]) == 0)
        path = tmp_path / "targets.flat.hdf"
        targets.save_hdf(path)
    cfg = {"library_path": str(path)}
    libs = {who: _load_library(tmp_path, who, cfg) for who in ("jax", "port")}
    assert_same_flat(libs["jax"], libs["port"], kind)
    assert set(np.asarray(libs["port"].precursor_df["decoy"]).tolist()) == {0, 1}


@pytest.mark.parametrize("coordinator", [None, "127.0.0.1:{port}"], ids=["no_address", "unreachable"])
def test_a_process_that_cannot_join_its_group_raises(tmp_path, light_step, monkeypatch, coordinator):
    """``WORLD_SIZE=2`` asks for a group: without a coordinator, or with one
    that no process serves, the step raises before it searches anything
    (it never searches alone)."""
    import socket

    import torch.distributed as dist

    from alphadia_torch.parallel import distributed

    for var in ("MASTER_ADDR", "MASTER_PORT", "ALPHADIA_TPU_COORDINATOR", "ALPHADIA_TPU_NUM_PROCESSES",
                "ALPHADIA_TPU_PROCESS_ID", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setattr(distributed, "DEFAULT_TIMEOUT_S", 3.0)
    if coordinator is not None:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        monkeypatch.setenv("ALPHADIA_TPU_COORDINATOR", coordinator.format(port=port))
    searched = []
    monkeypatch.setattr(SearchStep, "_process_raw_file", lambda self, p, n, q: searched.append(n))
    with pytest.raises((RuntimeError, ValueError)):
        step(tmp_path, config={"raw_paths": ["/a/r1.mzML"]}).run()
    assert searched == [] and not dist.is_initialized()


def test_no_library_raises(tmp_path):
    with pytest.raises(NoLibraryAvailableError):
        step(tmp_path).run()


# ---------------------------------------------------------------------------
# end to end against the JAX package
# ---------------------------------------------------------------------------
class _NoOutput:
    """The JAX step's cross-run aggregation, left out (the port's comes
    with the next slice)."""

    def __init__(self, *a):
        pass

    def build(self, *a):
        pass


def run_both(tmp, world: dict, config: dict, monkeypatch):
    """Both search steps on one world: {"jax": (step, workflow, psm),
    "port": (...)}, the flat libraries of ``load_library``, and the
    generator's targets (the truth)."""
    raw_path, lib_path, _, truth = write_search_inputs(tmp, world)
    cfg = {**config, "library_path": str(lib_path), "raw_paths": [str(raw_path)]}
    monkeypatch.setattr(jax_module, "SearchPlanOutput", _NoOutput)
    out = {}
    for who, module, make in (
        ("jax", jax_module, lambda: jax_module.SearchStep(str(tmp / "jax"), config=cfg)),
        ("port", port_module, lambda: SearchStep(str(tmp / "port"), config=cfg, device="cpu")),
    ):
        seen = []
        base = module.PeptideCentricWorkflow

        class Recording(base):
            def load(self, *a, **k):
                super().load(*a, **k)
                record_optimizers(self)
                seen.append(self)

        monkeypatch.setattr(module, "PeptideCentricWorkflow", Recording)
        s = make()
        s.run()
        assert not s.errors, s.errors
        out[who] = (s, seen[0], tmp / who / QUANT_FOLDER_NAME / "run")
    return out, truth


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        spec = WORLDS["3d"]
        return run_both(tmp_path_factory.mktemp("e2e"), spec["world"], spec["config"], mp)


def test_flat_library_matches_jax(both):
    runs, _ = both
    theirs, ours = runs["jax"][0].spectral_library, runs["port"][0].spectral_library
    for which in ("precursor_df", "fragment_df"):
        j, p = getattr(theirs, which), getattr(ours, which)
        assert list(j.columns) == list(p), which
        for c in j.columns:
            a, b = j[c].to_numpy(), p[c]
            if a.dtype == object:
                assert b.dtype == object and list(a) == list(b), (which, c)
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), (which, c)
    assert len(ours.precursor_df["precursor_idx"]) == 800


@pytest.mark.parametrize("name", ["psm.parquet", "frag.parquet"])
def test_parquet_has_jax_columns_and_types(both, name):
    runs, _ = both
    theirs, ours = pq.read_table(runs["jax"][2] / name), pq.read_table(runs["port"][2] / name)
    assert ours.num_rows > 0
    assert ours.schema.names == theirs.schema.names

    def arrow_type(t):  # pandas' text columns go to parquet as large_string
        return "string" if str(t) == "large_string" else str(t)

    assert [arrow_type(f.type) for f in ours.schema] == [arrow_type(f.type) for f in theirs.schema]
    assert dict(pd.read_parquet(runs["port"][2] / name).dtypes) == dict(pd.read_parquet(runs["jax"][2] / name).dtypes)
    # the port's reader gives pyarrow's reading
    mine = read_parquet(runs["port"][2] / name)
    for c, col in zip(ours.schema.names, ours.columns):
        assert list(mine[c]) == col.to_pylist() if mine[c].dtype == object else np.array_equal(
            mine[c], col.to_numpy(), equal_nan=mine[c].dtype.kind == "f"
        ), c


def test_steps_tolerances_and_ids_match_jax(both):
    runs, truth = both
    wf_j, wf_p = runs["jax"][1], runs["port"][1]
    assert steps_per_optimizer(wf_p) == steps_per_optimizer(wf_j)
    for k in TOLERANCES:
        a, b = getattr(wf_p.optimization_manager, k), getattr(wf_j.optimization_manager, k)
        assert abs(a - b) <= TOL_REL * abs(b), (k, a, b)
    psm_j = frame_from_pandas(pd.read_parquet(runs["jax"][2] / "psm.parquet"))
    psm_p = read_parquet(runs["port"][2] / "psm.parquet")
    ours, theirs = target_ids(psm_p), target_ids(psm_j)
    assert len(theirs) > 100
    assert len(ours & theirs) / len(ours | theirs) >= JACCARD_MIN
    identified, false, _, _ = search_id_shares(wf_p.dia_data.cycle_rt, truth, psm_p)
    assert identified > 0.5 and false < 0.1


# ---------------------------------------------------------------------------
# the JAX readings of chip_smoke.py phase [8]
# ---------------------------------------------------------------------------
def main():
    import tempfile
    from pathlib import Path

    ap = argparse.ArgumentParser(description="the search step on a quarter world, JAX and the port: the phase-[8] readings")
    ap.add_argument("--peptides", type=int, default=1500)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--mobility", action="store_true")
    ap.add_argument("--batch-size", type=int, default=None, help="calibration.batch_size (default: the config's)")
    ap.add_argument("--random-state", type=int, default=0, help="general.random_state of both steps")
    opt = ap.parse_args()
    world = dict(
        n_peptides=opt.peptides, n_windows=opt.windows, n_cycles=600, noise_peaks_per_spectrum=80, seed=5,
        with_mobility=opt.mobility,
    )
    config = {"general": {"random_state": opt.random_state, "save_figures": False}}
    if opt.batch_size is not None:
        config["calibration"] = {"batch_size": opt.batch_size}
    with tempfile.TemporaryDirectory() as tmp, pytest.MonkeyPatch.context() as mp:
        runs, truth = run_both(Path(tmp), world, config, mp)
        for who, (_, wf, folder) in runs.items():
            psm = frame_from_pandas(pd.read_parquet(folder / "psm.parquet"))
            om = wf.optimization_manager
            print(
                f"{who}: steps {steps_per_optimizer(wf)}, tolerances "
                + ", ".join(f"{k} {getattr(om, k):.4f}" for k in TOLERANCES)
                + f"; identified/false/targets/decoys {search_id_shares(wf.dia_data.cycle_rt, truth, psm)}",
                flush=True,
            )


if __name__ == "__main__":
    main()
