"""The port's cross-run outputs against the JAX package's, on the CPU.

Module cases (those of ``tests/unit/test_outputs.py``,
``test_grouping_taxonomy.py``, ``test_lfq_hand_verified.py``,
``test_quantselect.py`` and ``test_validation.py``), each run through both
packages on the same inputs:

- grouping: ``pg`` and ``pg_master`` per row equal, for the heuristic,
  parsimony and plain modes; ties of the set cover go to the protein seen
  first in both;
- quant: the ion union in the same row order, the filter's keep mask equal
  (ties of the mean correlation included), LFQ matrices with the same groups
  in the same order within rtol 1e-9;
- ``stat`` / ``internal`` rows, schema validation, the TSV writer (read back
  by ``pandas.read_csv`` to the values pandas' own writer gives).

Aggregation on the same inputs: the JAX ``SearchStep`` writes the per-run
parquet of two small runs; both packages' ``SearchPlanOutput.build``
aggregate that folder, for every inference strategy and both
normalization methods: the precursors table (same rows, same order,
numbers within rtol 1e-9), ``pg.matrix``, ``precursor.matrix``,
``peptide.matrix`` and ``stat.tsv`` equal; one case also writes
``fragment.matrix``, one writes the tables as TSV.
"""

import json
import logging

import numpy as np
import pandas as pd
import pytest

from alphadia_torch.config import load_default_config
from alphadia_torch.outputs import quant
from alphadia_torch.outputs.df_builders import build_internal_df, build_stat_df
from alphadia_torch.outputs.grouping import perform_grouping
from alphadia_torch.outputs.search_plan_output import SearchPlanOutput
from alphadia_torch.utils.tsv import read_tsv, to_tsv_text, write_tsv
from alphadia_torch.validation import Optional, Required, Schema
from alphadia_torch.validation.schemas import candidates_schema, fragments_flat_schema, precursors_flat_schema
from alphadia_tpu.config import load_default_config as jax_load_default_config
from alphadia_tpu.outputs import quant as jax_quant
from alphadia_tpu.outputs.df_builders import build_internal_df as jax_build_internal_df
from alphadia_tpu.outputs.df_builders import build_stat_df as jax_build_stat_df
from alphadia_tpu.outputs.grouping import perform_grouping as jax_perform_grouping
from alphadia_tpu.outputs.search_plan_output import SearchPlanOutput as JaxSearchPlanOutput
from alphadia_tpu.validation import Optional as JaxOptional
from alphadia_tpu.validation import Required as JaxRequired
from alphadia_tpu.validation import Schema as JaxSchema
from torch_workflow_worlds import E2E_OVERRIDES, write_cli_inputs

pytest_plugins = ("torch_port_plugin",)


def _frame(df: pd.DataFrame) -> dict:
    return {c: df[c].to_numpy() for c in df.columns}


def _assert_frame_equal(got: dict, want: pd.DataFrame, rtol=1e-9, what=""):
    assert list(got) == [str(c) for c in want.columns], what
    for c in want.columns:
        g, w = np.asarray(got[str(c)]), want[c].to_numpy()
        assert len(g) == len(w), f"{what} {c}"
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=rtol, atol=0, err_msg=f"{what} {c}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {c}")


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------
TAXONOMY = {
    "distinct": ["A", "A", "B", "B"],
    "differentiable": ["A", "A;B", "A;B", "B"],
    "indistinguishable": ["A;B", "A;B", "A;B", "A;B"],
    "subset": ["A", "A;B", "A;B", "A"],
    "subsumable": ["A", "A;B", "B;C", "C"],
    "shared_only": ["A;B", "A;B", "A;C", "A;C"],
    "circular": ["A;C", "B;C", "B;C", "A"],
    "complex": ["P1;P2;P3", "P1;P4", "P2;P5", "P2"],
    "parsimony": ["P1", "P1;P2", "P1", "P3"],
    "ties_in_seen_order": ["Z;A", "A;Z", "M", "Q;M"],
}


def _grouping_cases():
    cases = []
    for name, prots in TAXONOMY.items():
        cases.append((name, pd.DataFrame({"precursor_idx": np.arange(len(prots)), "proteins": prots, "decoy": 0})))
    cases.append(("decoy_separate", pd.DataFrame({"precursor_idx": [1, 2], "proteins": ["P1", "P1"], "decoy": [0, 1]})))
    cases.append(("decoys_grouped_separately",
                  pd.DataFrame({"precursor_idx": [0, 1, 2, 3], "proteins": ["A;B", "B", "A;B", "B"], "decoy": [0, 0, 1, 1]})))
    cases.append(("repeated_precursor",
                  pd.DataFrame({"precursor_idx": [0, 0, 1], "proteins": ["A", "A", "A;B"], "decoy": 0})))
    cases.append(("genes", pd.DataFrame({"precursor_idx": [0, 1, 2], "genes": ["G1", "G1;G2", "G2"],
                                         "proteins": ["x", "y", "z"], "decoy": 0})))
    rng = np.random.default_rng(11)
    proteins = [f"P{i}" for i in range(30)]
    for trial in range(10):
        n = int(rng.integers(5, 200))
        prots = [";".join(rng.choice(proteins, size=int(rng.integers(1, 4)), replace=False)) for _ in range(n)]
        # rows out of precursor order, some precursors in several runs
        idx = rng.permutation(n)
        df = pd.DataFrame({"precursor_idx": idx, "proteins": prots, "decoy": rng.integers(0, 2, n)})
        cases.append((f"random_{trial}", pd.concat([df, df.sample(frac=0.3, random_state=trial)], ignore_index=True)))
    return cases


@pytest.mark.parametrize("mode", ["heuristic", "maximum_parsimony", "plain"])
@pytest.mark.parametrize("name,df", _grouping_cases(), ids=[c[0] for c in _grouping_cases()])
def test_grouping_matches_jax(name, df, mode):
    level = "genes" if name == "genes" else "proteins"
    kw = dict(genes_or_proteins=level, group=mode == "heuristic", return_parsimony_groups=mode == "maximum_parsimony")
    want = jax_perform_grouping(df.copy(), **kw)
    got = perform_grouping(_frame(df), **kw)
    for c in ("precursor_idx", "pg_master", "pg"):
        np.testing.assert_array_equal(np.asarray(got[c]), want[c].to_numpy(), err_msg=f"{name} {c}")


# ---------------------------------------------------------------------------
# quantification
# ---------------------------------------------------------------------------
RUNS = ["runA", "runB", "runC"]
RUN_FACTOR = {"runA": 1.0, "runB": 2.0, "runC": 0.5}


def _quant_runs(n_prec=50, n_frag=6, missing=0.0, noisy_ion=False, seed=0, float32=True, ties=False):
    """The runs of ``tests/unit/test_quantselect.py`` (missing ions, a noisy
    ion), float32 features as the per-run parquet holds them; ``ties``
    quantizes the correlations so that the filter's ranks tie."""
    rng = np.random.default_rng(seed)
    base = 10 ** rng.uniform(3.5, 6, n_prec)
    shape = np.array([1.0, 0.6, 0.4, 0.3, 0.2, 0.1])[:n_frag]
    runs = {}
    for r, run in enumerate(RUNS):
        rows = []
        for p in rng.permutation(n_prec) if r else range(n_prec):
            for f in range(n_frag):
                inten = base[p] * RUN_FACTOR[run] * shape[f] * rng.uniform(0.9, 1.1)
                corr = rng.uniform(0.85, 1.0)
                me = rng.normal(0, 1.0)
                if noisy_ion and f == 0:
                    inten = base[p] * 10 ** rng.uniform(-1.5, 1.5)
                    corr, me = rng.uniform(0.0, 0.2), rng.normal(0, 12.0)
                if ties:
                    corr = round(corr * 20) / 20
                if rng.random() < missing:
                    continue
                rows.append({"precursor_idx": p, "number": f + 1, "type": 121, "charge": 1, "loss_type": 0,
                             "intensity": inten, "correlation": corr, "mass_error": me, "height": inten * 0.8})
        df = pd.DataFrame(rows)
        df["precursor_idx"] = df["precursor_idx"].astype(np.uint32)
        if float32:
            for c in ("intensity", "correlation", "mass_error", "height"):
                df[c] = df[c].astype(np.float32)
        runs[run] = df
    return runs, base


QUANT_CASES = {
    "complete": dict(),
    "missing": dict(missing=0.3),
    "noisy_ion": dict(n_prec=40, noisy_ion=True, seed=3),
    "ties": dict(missing=0.2, ties=True, seed=5),
    "float64": dict(missing=0.1, float32=False, seed=7),
}


@pytest.mark.parametrize("case", QUANT_CASES)
def test_quant_matches_jax(case):
    runs, _ = _quant_runs(**QUANT_CASES[case])
    want = jax_quant.accumulate_frag_df(runs, columns=jax_quant.QUANTSELECT_FEATURES)
    got = quant.accumulate_frag_df({k: _frame(v) for k, v in runs.items()}, columns=quant.QUANTSELECT_FEATURES)
    for c in want:
        _assert_frame_equal(got[c], want[c], rtol=0, what=f"accumulate {c}")

    group_keys = (want["intensity"]["precursor_idx"] % 7).to_numpy()
    for top_n, min_corr, keys in ((3, 0.99, None), (2, 0.9, group_keys), (12, 0.9, None)):
        wi, wc, wk = jax_quant.filter_frag_df(want["intensity"], want["correlation"], min_correlation=min_corr,
                                              top_n=top_n, group_keys=keys)
        gi, gc, gk = quant.filter_frag_df(got["intensity"], got["correlation"], min_correlation=min_corr, top_n=top_n,
                                          group_keys=keys)
        np.testing.assert_array_equal(gk, wk)
        _assert_frame_equal(gi, wi.reset_index(drop=True), rtol=0, what="filter")

    keys = want["intensity"]["precursor_idx"]
    for normalize, num_samples, min_nonnan in ((True, None, 1), (True, 50, 3), (False, None, 2)):
        w = jax_quant.direct_lfq(want["intensity"], keys, RUNS, normalize=normalize, min_nonnan=min_nonnan,
                                 num_samples=num_samples)
        g = quant.direct_lfq(got["intensity"], keys.to_numpy(), RUNS, normalize=normalize, min_nonnan=min_nonnan,
                             num_samples=num_samples)
        _assert_frame_equal(g, w, what="direct_lfq")

    np.testing.assert_allclose(quant.quantselect_ion_scores(got, RUNS), jax_quant.quantselect_ion_scores(want, RUNS),
                               rtol=1e-12, atol=0)
    w = jax_quant.quantselect_lfq(want, keys, RUNS, min_nonnan=1)
    g = quant.quantselect_lfq(got, keys.to_numpy(), RUNS, min_nonnan=1)
    _assert_frame_equal(g, w, what="quantselect_lfq")


def test_ion_scores_without_optional_features_match_jax():
    runs, _ = _quant_runs(n_prec=5)
    want = jax_quant.accumulate_frag_df(runs, columns=("intensity",))
    got = quant.accumulate_frag_df({k: _frame(v) for k, v in runs.items()}, columns=("intensity",))
    np.testing.assert_allclose(quant.quantselect_ion_scores(got, RUNS), jax_quant.quantselect_ion_scores(want, RUNS),
                               rtol=1e-12)


HAND = {
    "trace_alignment": np.array([[10.0, 11.0, 12.0], [12.0, 13.0, np.nan], [9.0, np.nan, 11.0]]),
    "offset": np.array([[10.0, 11.0, 12.0], [19.3, 20.3, np.nan], [9.0, np.nan, 11.0]]),
    "single_ion": np.array([[4.0, 6.0, np.nan]]),
    "normalize": np.array([[10.0, 12.0, 11.0], [13.0, 14.0, np.nan], [20.0, 22.5, 21.0]]),
}


@pytest.mark.parametrize("name", HAND)
def test_hand_verified_lfq_matches_jax(name):
    m = HAND[name]
    np.testing.assert_allclose(quant.estimate_group_intensity(m), jax_quant.estimate_group_intensity(m), rtol=1e-12)
    np.testing.assert_allclose(quant.normalize_samples(m), jax_quant.normalize_samples(m), rtol=1e-12)
    if name == "trace_alignment":
        np.testing.assert_allclose(quant.estimate_group_intensity(m), [10.0, 11.25, 12.0])
    ions = pd.DataFrame({"A": [2.0**10, 2.0**10.5, 2.0**14, 2.0**14.5], "B": [2.0**9, 2.0**9.5, 2.0**13, 2.0**13.5]})
    groups = pd.Series(["g1", "g1", "g2", "g2"])
    want = jax_quant.direct_lfq(ions, groups, ["A", "B"], normalize=True)
    got = quant.direct_lfq(_frame(ions), groups.to_numpy(), ["A", "B"], normalize=True)
    _assert_frame_equal(got, want)
    np.testing.assert_allclose(np.log2(got["A"]), [10.25, 14.25], atol=1e-9)


# ---------------------------------------------------------------------------
# stat / internal rows, validation, TSV
# ---------------------------------------------------------------------------
def test_stat_and_internal_rows_match_jax():
    empty = pd.DataFrame({"channel": pd.Series([], dtype="int64"), "pg": pd.Series([], dtype=object)})
    opt, cal = {"ms1_error": 5.0, "ms2_error": 10.0}, {"ms2_median_accuracy": 1.5}
    want = jax_build_stat_df("empty_run", empty, optimization_state=opt, calibration_metrics=cal)
    got = build_stat_df("empty_run", _frame(empty), optimization_state=opt, calibration_metrics=cal)
    assert got["precursors"].tolist() == [0] and got["proteins"].tolist() == [0]
    _assert_frame_equal(got, want)
    psm = pd.DataFrame({"channel": [0, 0, 4], "pg": ["A", "B", "A"], "cycle_fwhm": np.float32([2.0, 3.1, 4.0])})
    _assert_frame_equal(build_stat_df("run", _frame(psm)), jax_build_stat_df("run", psm))
    timings = {"load": {"duration": 1.5}, "extraction": {"duration": 2.25}}
    _assert_frame_equal(build_internal_df("run", timings), jax_build_internal_df("run", timings))


def _schema(pkg):
    req, opt, schema = (Required, Optional, Schema) if pkg == "port" else (JaxRequired, JaxOptional, JaxSchema)
    return schema("test", [req("idx", np.uint32), req("mz", np.float32), opt("decoy", np.uint8), opt("seq", object)])


VALIDATION = {
    "valid": (dict(), None),
    "missing_required": ({"mz": None}, "missing required column 'mz'"),
    "coerce": ({"mz": np.linspace(400, 500, 4)}, None),
    "uncoercible": ({"mz": ["a", "b", "c", "d"]}, "cannot coerce"),
    "object_column": ({"seq": [1, "x", None, 3.5]}, None),
    "nan_inf": ({"mz": np.array([1.0, np.nan, np.inf, 4.0], np.float32)}, None),
}


@pytest.mark.parametrize("case", VALIDATION)
def test_validation_matches_jax(case, caplog):
    over, error = VALIDATION[case]
    base = {"idx": np.arange(4, dtype=np.uint32), "mz": np.linspace(400, 500, 4).astype(np.float32)}
    base.update({k: v for k, v in over.items() if v is not None})
    for k, v in over.items():
        if v is None:
            base.pop(k)
    results = {}
    for pkg, df in (("jax", pd.DataFrame(base)), ("port", {k: np.asarray(v) if not isinstance(v, list) else np.array(v, object) for k, v in base.items()})):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            if error:
                with pytest.raises(ValueError, match=error):
                    _schema(pkg).validate(df, warn_on_critical_values=True)
                continue
            out = _schema(pkg).validate(df, warn_on_critical_values=True)
        assert out is df
        results[pkg] = ({c: np.asarray(out[c]).dtype for c in base}, [r.message for r in caplog.records])
    if not error:
        assert results["port"] == results["jax"]
    with pytest.raises(TypeError):
        _schema("port").validate([1, 2])


def test_shipped_schemas_accept_pipeline_frames():
    precursors_flat_schema.validate({
        "precursor_idx": np.arange(3, dtype=np.uint32), "flat_frag_start_idx": np.array([0, 2, 4], np.uint32),
        "flat_frag_stop_idx": np.array([2, 4, 6], np.uint32), "rt_library": np.ones(3, np.float32),
        "mz_library": np.full(3, 500.0, np.float32)})
    fragments_flat_schema.validate({
        "mz_library": np.full(6, 300.0, np.float32), "intensity": np.ones(6, np.float32),
        "type": np.full(6, 98, np.uint8), "charge": np.ones(6, np.uint8), "number": np.arange(6, dtype=np.uint8),
        "position": np.arange(6, dtype=np.uint8)})
    candidates_schema.validate({c: np.zeros(2, np.int64) for c in (
        "precursor_idx", "scan_start", "scan_center", "scan_stop", "frame_start", "frame_center", "frame_stop")})


def test_tsv_reads_back_as_pandas_writes_it(tmp_path):
    import io

    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "f32": np.float32(rng.normal(size=6) * 10.0 ** rng.integers(-8, 8, 6)),
        "f64": rng.normal(size=6) * 10.0 ** rng.integers(-20, 20, 6),
        "int": np.array([1, -2, 3, 4, 5, 2**40]),
        "u64": np.array([1, 2, 3, 4, 5, 2**63 + 11], np.uint64),
        "text": ["a", None, "x\ty", "P1;P2", 'q"', "é"],
        "flag": [True, False, True, True, False, True],
    })
    df.loc[2, "f32"] = np.nan
    df.loc[3, "f64"] = np.inf
    write_tsv(_frame(df), tmp_path / "ours.tsv")
    ours = pd.read_csv(tmp_path / "ours.tsv", sep="\t")
    theirs = pd.read_csv(io.StringIO(df.to_csv(sep="\t", index=False)), sep="\t")
    pd.testing.assert_frame_equal(ours, theirs)
    assert to_tsv_text(_frame(df)) == df.to_csv(sep="\t", index=False)
    # the reader parses floats exactly (pandas' default parser may miss by an ulp)
    back = read_tsv(tmp_path / "ours.tsv")
    exact = pd.read_csv(tmp_path / "ours.tsv", sep="\t", float_precision="round_trip")
    np.testing.assert_array_equal(back["f64"], exact["f64"].to_numpy())
    assert back["int"].dtype == np.int64 and back["flag"].dtype == bool


# ---------------------------------------------------------------------------
# aggregation of one folder of per-run files by both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def per_run_folder(tmp_path_factory):
    """Two small runs searched by the JAX ``SearchStep`` (its own
    aggregation left out): (quant folders, config overrides)."""
    import alphadia_tpu.search_step as jax_step

    tmp = tmp_path_factory.mktemp("agg")
    world = dict(n_peptides=200, n_windows=4, n_cycles=300, seed=31)
    raws, lib, _, _ = write_cli_inputs(tmp, world)
    cfg = {**json.loads(json.dumps(E2E_OVERRIDES)), "library_path": str(lib), "raw_paths": [str(r) for r in raws]}

    class NoOutput:
        def __init__(self, *a):
            pass

        def build(self, *a):
            pass

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_step, "SearchPlanOutput", NoOutput)
        step = jax_step.SearchStep(str(tmp / "jax_step"), config=cfg)
        step.run()
    assert not step.errors
    return [tmp / "jax_step" / "quant" / f"run_{i}" for i in range(len(raws))], tmp


# one case writes the fragment matrix too, one writes TSV tables
EXTRA_OUTPUT = {("heuristic", "directlfq"): {"save_fragment_quant_matrix": True},
                ("library", "quantselect"): {"file_format": "tsv"}}


def _configs(strategy, method):
    patch = {"fdr": {"inference_strategy": strategy},
             "search_output": {"normalization_method": method, **EXTRA_OUTPUT.get((strategy, method), {})},
             "general": {"save_mbr_library": False}}
    theirs, ours = jax_load_default_config(), load_default_config()
    theirs.update_layer(patch)
    ours.update_layer(patch)
    return theirs, ours


@pytest.mark.parametrize("method", ["directlfq", "quantselect"])
@pytest.mark.parametrize("strategy", ["heuristic", "maximum_parsimony", "library"])
def test_aggregation_matches_jax(per_run_folder, strategy, method):
    folders, tmp = per_run_folder
    theirs_cfg, ours_cfg = _configs(strategy, method)
    out_j, out_p = tmp / f"j_{strategy}_{method}", tmp / f"p_{strategy}_{method}"
    out_j.mkdir()
    out_p.mkdir()
    JaxSearchPlanOutput(theirs_cfg, out_j).build(folders)
    SearchPlanOutput(ours_cfg, out_p).build(folders)

    tsv = ours_cfg["search_output"]["file_format"] == "tsv"
    names = ["precursors", "pg.matrix", "precursor.matrix", "peptide.matrix"]
    if ours_cfg["search_output"]["save_fragment_quant_matrix"]:
        names.append("fragment.matrix")
    for name in names:
        if tsv:
            want = pd.read_csv(out_j / f"{name}.tsv", sep="\t")
            got = pd.read_csv(out_p / f"{name}.tsv", sep="\t")
        else:
            want = pd.read_parquet(out_j / f"{name}.parquet")
            got = pd.read_parquet(out_p / f"{name}.parquet")
        assert len(want) > 20, name
        assert list(got.columns) == list(want.columns), name
        for c in want.columns:
            if want[c].dtype.kind == "f":
                np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(), rtol=1e-9, atol=0, err_msg=f"{name} {c}")
            else:
                np.testing.assert_array_equal(got[c].to_numpy(), want[c].to_numpy(), err_msg=f"{name} {c}")
    want = pd.read_csv(out_j / "stat.tsv", sep="\t")
    got = pd.read_csv(out_p / "stat.tsv", sep="\t")
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-12)
    assert list(pd.read_csv(out_p / "internal.tsv", sep="\t").columns) == list(pd.read_csv(out_j / "internal.tsv", sep="\t").columns)
