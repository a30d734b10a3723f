"""The small worlds and configs of the workflow tests, and the port's
workflow run on one of them; imports nothing of JAX, so that the card tests
use it too.

The 3D world and config are those of ``tests/integration/test_workflow.py``,
the 4D ones those of ``tests/integration/test_workflow_4d.py``.
"""

from __future__ import annotations

import time

WORLDS = {
    "3d": dict(
        world=dict(n_peptides=400, n_windows=6, n_cycles=400, seed=11, lib_ppm_bias=5.0, lib_rt_sigma=10.0),
        config={
            "general": {"random_state": 42, "save_figures": False},
            "calibration": {"batch_size": 150, "optimization_lock_target": 100, "min_steps": 2, "max_steps": 6},
            "search": {"target_ms1_tolerance": 10, "target_ms2_tolerance": 12, "target_rt_tolerance": 30},
            "search_initial": {"ms1_tolerance": 25, "ms2_tolerance": 25, "rt_tolerance": 0.3},
            "tpu": {"selection_batch": 256, "scoring_batch": 256},
        },
    ),
    "4d": dict(
        world=dict(
            n_peptides=300, n_windows=6, n_cycles=300, seed=23, lib_ppm_bias=5.0, lib_rt_sigma=10.0,
            with_mobility=True,
        ),
        config={
            "general": {"random_state": 7, "save_figures": False},
            "calibration": {"batch_size": 150, "optimization_lock_target": 80, "min_steps": 2, "max_steps": 5},
            "search": {
                "target_ms1_tolerance": 10, "target_ms2_tolerance": 12, "target_rt_tolerance": 30,
                "target_mobility_tolerance": 0.1,
            },
            "search_initial": {"ms1_tolerance": 25, "ms2_tolerance": 25, "rt_tolerance": 0.3},
            "tpu": {"selection_batch": 256, "scoring_batch": 256},
        },
    ),
}

TOLERANCES = ("ms1_error", "ms2_error", "rt_error", "mobility_error")


def record_optimizers(wf):
    """Keep the optimizer groups the loop builds in ``wf.ordered_optimizers``
    (works on either package's workflow)."""
    handler = wf.optimization_handler
    build = handler._get_ordered_optimizers

    def recording():
        wf.ordered_optimizers = build()
        return wf.ordered_optimizers

    handler._get_ordered_optimizers = recording


def steps_per_optimizer(wf) -> dict:
    return {o.parameter_name: o._num_prev_optimizations for group in wf.ordered_optimizers for o in group}


def target_ids(psm: dict, fdr: float = 0.01) -> set:
    return set(psm["precursor_idx"][(psm["qval"] <= fdr) & (psm["decoy"] == 0)].tolist())


def run_workflow(make_workflow, cfg, raw_path, library, out_dir):
    """load -> search_parameter_optimization -> extraction; the workflow
    (with ``wall`` set) and its PSMs and fragments."""
    cfg.update_layer({"output_directory": str(out_dir)}, name="output")
    wf = make_workflow(cfg)
    t0 = time.perf_counter()
    wf.load(raw_path, library)
    record_optimizers(wf)
    wf.search_parameter_optimization()
    psm, frag = wf.extraction()
    wf.wall = time.perf_counter() - t0
    return wf, psm, frag


def run_port(tmp, kind: str, device, random_state=None):
    """The port's workflow on a small world (the port's generator, which
    gives the JAX package's arrays): (workflow, psm, fragments,
    precursors)."""
    from alphadia_torch.config import load_default_config
    from alphadia_torch.library.speclib import SpecLibFlat
    from alphadia_torch.rawdata import save_npz
    from alphadia_torch.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
    from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow

    spec = WORLDS[kind]
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(**spec["world"]))
    prec, frag = add_synthetic_decoys(prec, frag)
    raw_path = tmp / f"{kind}.npz"
    save_npz(raw_path, spectra)
    cfg = load_default_config()
    cfg.update_layer(spec["config"], name="test")
    wf, psm, fragments = run_workflow(
        lambda c: PeptideCentricWorkflow("synthetic", c, random_state=random_state, device=device),
        cfg, str(raw_path), SpecLibFlat(prec, frag), tmp / f"out_{device}",
    )
    return wf, psm, fragments, prec


def compare_runs(a, b) -> dict:
    """Steps per optimizer of both, the largest relative tolerance
    difference, and the Jaccard overlap of the target IDs at 1% FDR."""
    (wf_a, psm_a), (wf_b, psm_b) = a, b
    rel = max(
        abs(getattr(wf_a.optimization_manager, k) - getattr(wf_b.optimization_manager, k))
        / abs(getattr(wf_b.optimization_manager, k))
        for k in TOLERANCES
    )
    ia, ib = target_ids(psm_a), target_ids(psm_b)
    return {
        "steps": (steps_per_optimizer(wf_a), steps_per_optimizer(wf_b)),
        "tolerance_rel": rel,
        "jaccard": len(ia & ib) / max(len(ia | ib), 1),
        "ids": (len(ia), len(ib)),
    }


def write_search_inputs(tmp, world: dict):
    """A seeded world of the port's generator, its m/z and isotope envelopes
    taken from the sequences (``from_sequence``), as a search step's inputs:
    (mzML path, TSV transition list path of its targets, spectra, targets)."""
    from alphadia_torch.testing.mzml_writer import write_mzml
    from alphadia_torch.testing.synthetic import SyntheticConfig, make_synthetic_dia
    from alphadia_torch.testing.tsv_library import write_transition_list

    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(**world, from_sequence=True))
    raw_path, lib_path = tmp / "run.mzML", tmp / "library.tsv"
    write_mzml(raw_path, spectra)
    write_transition_list(lib_path, prec, frag)
    return raw_path, lib_path, spectra, prec


def search_id_shares(cycle_rt, truth: dict, psm: dict, fdr: float = 0.01) -> tuple[float, float, int, int]:
    """(identified share, realised false share, targets, decoys at ``fdr``)
    of a search step's PSMs against the generator's truth, matched by
    (sequence, charge): the library the step builds numbers its precursors
    anew. The identified share is that of detectable targets with a target
    PSM at q <= fdr; the false share that of the accepted targets whose PSM
    lies more than 3 cycles from the true apex."""
    import numpy as np

    accepted = psm["qval"] <= fdr
    target = psm["decoy"] == 0
    row = {(str(s), int(z)): i for i, (s, z) in enumerate(zip(truth["sequence"], truth["charge"]))}
    hits = [row[(str(s), int(z))] for s, z in zip(psm["sequence"][accepted & target], psm["charge"][accepted & target])]
    rows = np.array(hits, np.int64)
    det = np.nonzero(truth["_truth_detectable"])[0]
    identified = float(np.isin(det, rows).mean()) if len(det) else 0.0
    truth_cycle = np.abs(cycle_rt[None, :] - truth["_truth_rt"][rows][:, None]).argmin(1)
    off = np.abs(psm["frame_center"][accepted & target] - truth_cycle) > 3
    return identified, float(off.mean()) if len(off) else 0.0, int(len(rows)), int((accepted & ~target).sum())


def run_search_step(out_dir, raw_path, lib_path, config: dict, device):
    """The port's ``SearchStep`` on one raw file: (step, its workflow with
    ``ordered_optimizers`` recorded, the psm frame read back from
    ``psm.parquet``)."""
    import alphadia_torch.search_step as search_step
    from alphadia_torch.utils.parquet import read_parquet

    seen = []
    base = search_step.PeptideCentricWorkflow

    class Recording(base):
        def load(self, *a, **k):
            super().load(*a, **k)
            record_optimizers(self)
            seen.append(self)

    search_step.PeptideCentricWorkflow = Recording
    try:
        step = search_step.SearchStep(
            str(out_dir), config={**config, "library_path": str(lib_path), "raw_paths": [str(raw_path)]}, device=device
        )
        step.run()
    finally:
        search_step.PeptideCentricWorkflow = base
    if step.errors:
        raise RuntimeError(f"the search step failed: {step.errors}")
    return step, seen[0], read_parquet(seen[0].path / "psm.parquet")


# the two runs of ``tests/e2e/test_cli_e2e.py``: same peptides, other
# acquisition noise, intensity level and RT shift
E2E_WORLD = dict(n_peptides=300, n_windows=6, n_cycles=350, seed=21)
E2E_RUNS = ((101, 1.0, 0.0), (202, 1.6, 4.0))
E2E_OVERRIDES = {
    "general": {"random_state": 1, "save_figures": False},
    "calibration": {"batch_size": 150, "optimization_lock_target": 80, "min_steps": 2, "max_steps": 5},
    "search": {"target_ms1_tolerance": 10, "target_ms2_tolerance": 12, "target_rt_tolerance": 30},
    "tpu": {"selection_batch": 256, "scoring_batch": 256},
}


# phase [9] of ``chip_smoke.py``: two runs of the search step's quarter 3D
# world (that of ``tests/test_torch_search_step.py``'s script mode), the
# runs differing as the e2e runs do
CLI_WORLD = dict(n_peptides=1500, n_windows=3, n_cycles=600, noise_peaks_per_spectrum=80, seed=5)


def write_cli_inputs(tmp, world: dict, runs=E2E_RUNS, raw_format: str = "mzML") -> tuple[list, object, dict, list]:
    """Runs of one seeded world from sequences as mzML (``run_<i>.mzML``)
    or, with ``raw_format="hdf"``, alphaRaw HDF (``run_<i>.hdf``), each run
    with its acquisition seed, intensity factor and RT shift, and a TSV
    transition list of the targets with digest-like protein groups
    (``assign_proteins``): (raw paths, library path, targets, each run's
    cycle RTs)."""
    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.testing.alpharaw_writer import save_alpharaw_hdf
    from alphadia_torch.testing.mzml_writer import write_mzml
    from alphadia_torch.testing.synthetic import SyntheticConfig, make_synthetic_dia
    from alphadia_torch.testing.tsv_library import assign_proteins, write_transition_list

    raw_paths, cycle_rts, prec, frag = [], [], None, None
    for i, (acq, factor, shift) in enumerate(runs):
        spectra, p, f = make_synthetic_dia(
            SyntheticConfig(**world, acq_seed=acq, run_intensity_factor=factor, run_rt_shift=shift, from_sequence=True)
        )
        if prec is None:
            prec, frag = p, f
        path = tmp / f"run_{i}.{raw_format}"
        if raw_format == "hdf":
            save_alpharaw_hdf(path, spectra)
        else:
            write_mzml(path, spectra)
        raw_paths.append(path)
        cycle_rts.append(DiaData.from_spectra(spectra).cycle_rt)
    prec = dict(prec)
    prec["proteins"], prec["genes"] = assign_proteins(len(prec["sequence"]), world["seed"])
    lib_path = tmp / "library.tsv"
    write_transition_list(lib_path, prec, frag)
    return raw_paths, lib_path, prec, cycle_rts


def spectra_sha256(spectra) -> str:
    """sha256 over a ``SpectrumData``'s decoded arrays (names, dtypes and
    bytes): input identity that does not depend on a file's compression."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for f in ("rt", "ms_level", "isolation_lower_mz", "isolation_upper_mz", "peak_start_idx", "peak_stop_idx", "mz",
              "intensity", "mobility"):
        a = getattr(spectra, f)
        if a is not None:
            a = np.ascontiguousarray(a)
            h.update(f.encode() + a.dtype.str.encode() + a.tobytes())
    return h.hexdigest()


def cli_readings(out, truth: dict, cycle_rts: list) -> dict:
    """What phase [9] gates, read from a CLI run's output folder ``out``
    (either package's files; no JAX needed): per run the identified and
    false shares at 1% FDR (``search_id_shares`` of the run's
    ``psm.parquet``); the protein groups left at 1% protein FDR; the groups
    each LFQ level quantifies; the median and MAD of the run-to-run log2
    ratio of ``pg.matrix``; per run the ``optimization.*`` tolerances of
    ``stat.tsv``."""
    from pathlib import Path

    import numpy as np

    from alphadia_torch.utils.parquet import read_parquet
    from alphadia_torch.utils.tsv import read_tsv

    out = Path(out)
    r = {}
    for i, cycle_rt in enumerate(cycle_rts):
        psm = read_parquet(out / "quant" / f"run_{i}" / "psm.parquet")
        r[f"identified_run_{i}"], r[f"false_run_{i}"], _, _ = search_id_shares(cycle_rt, truth, psm)
    prec = read_parquet(out / "precursors.parquet")
    r["protein_groups"] = len(set(prec["pg.name"][prec["precursor.decoy"] == 0].tolist()))
    for level in ("precursor", "peptide", "pg"):
        r[f"groups_{level}"] = len(read_parquet(out / f"{level}.matrix.parquet")["group"])
    pg = read_parquet(out / "pg.matrix.parquet")
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.log2(pg["run_1"] / pg["run_0"])
    ratio = ratio[np.isfinite(ratio)]
    r["log2_ratio_median"] = float(np.median(ratio))
    r["log2_ratio_mad"] = float(np.median(np.abs(ratio - np.median(ratio))))
    stat = read_tsv(out / "stat.tsv")
    for i in range(len(cycle_rts)):
        for k in ("ms1_error", "ms2_error", "rt_error"):
            r[f"{k}_run_{i}"] = float(stat[f"optimization.{k}"][i])
    return r


# phase [10a] of ``chip_smoke.py``: the library-free search on one run. A
# seeded FASTA of 20 proteins (``testing/fasta.py``: the human proteome's
# residue composition and length distribution), whose digest at the default
# ``library_prediction`` settings gives 3,172 target precursors; the run
# plants the library that digest and the packaged models predict, in 3
# windows over the digest's m/z range
LIBRARY_FREE_WORLD = dict(
    n_proteins=20, fasta_seed=0, n_windows=3, n_cycles=600, noise_peaks_per_spectrum=80, seed=5,
    detectable_fraction=0.9, precursor_mz_range=(400.0, 1200.0),
)


def predicted_library(fasta_paths, prediction=None, **digest_kw):
    """Digest -> ``prediction`` (``SimplePrediction`` with the packaged
    models on the CPU unless given) -> isotopes -> flatten, as the
    library-free e2e test builds the library it plants: the flat library."""
    from alphadia_torch.library.digest import digest_fasta
    from alphadia_torch.library.flatten import FlattenLibrary, InitFlatColumns
    from alphadia_torch.library.harmonize import IsotopeGenerator, PrecursorInitializer
    from alphadia_torch.models.prediction import SimplePrediction

    lib = digest_fasta([str(p) for p in fasta_paths], **digest_kw)
    prediction = prediction or SimplePrediction(device="cpu")
    lib = IsotopeGenerator()(prediction(PrecursorInitializer()(lib)))
    return InitFlatColumns()(FlattenLibrary()(lib))


def library_run_truth(precursor: dict, cfg) -> dict:
    """The targets ``make_run_from_library`` plants, by (sequence, mods,
    charge): ``_truth_detectable`` (drawn detectable, inside the run's m/z
    range, with fragments) and ``_truth_rt``, its elution centre. Replays
    the generator's two draws before the acquisition."""
    import numpy as np

    t = {k: v[precursor["decoy"] == 0] for k, v in precursor.items()}
    n = len(t["charge"])
    rng = np.random.default_rng(cfg.seed)
    rng.normal(0.0, 0.4, n)  # the amplitudes
    detectable = rng.random(n) < cfg.detectable_fraction
    rt = t["rt_library" if "rt_library" in t else "rt_norm"].astype(np.float64)
    gradient = cfg.n_cycles * cfg.cycle_time
    rt_center = rt if rt.max() > 1.5 else 0.05 * gradient + rt * 0.9 * gradient
    mz = t["mz_library" if "mz_library" in t else "precursor_mz"].astype(np.float64)
    in_range = (cfg.precursor_mz_range[0] < mz) & (mz < cfg.precursor_mz_range[1])
    has_frags = t["flat_frag_stop_idx"] > t["flat_frag_start_idx"]
    return {
        "sequence": t["sequence"], "mods": t["mods"], "charge": t["charge"],
        "_truth_detectable": detectable & in_range & has_frags, "_truth_rt": rt_center,
    }


def _float64_prediction():
    """``SimplePrediction`` with the packaged models in float64 on the CPU,
    their outputs rounded to float32: every machine predicts the same
    float32 values, where float32 products differ in their last bits between
    CPUs and library builds."""
    import numpy as np
    import torch

    from alphadia_torch.models.finetune import FinetuneManager
    from alphadia_torch.models.prediction import PACKAGED_MODELS, SimplePrediction

    class Float64Manager(FinetuneManager):
        def _run(self, fn, arrays):
            with torch.inference_mode():
                inputs = [torch.from_numpy(a.astype(np.float64) if a.dtype.kind == "f" else a) for a in arrays]
                return fn(*inputs).to(torch.float32).numpy()

    class Float64Prediction(SimplePrediction):
        def _load_manager(self):
            manager = Float64Manager.load(PACKAGED_MODELS, device="cpu")
            for model in manager.models.values():
                model.double()
            return manager

    return Float64Prediction(device="cpu")


def write_library_free_inputs(tmp, world: dict = LIBRARY_FREE_WORLD):
    """The FASTA and the mzML of a library-free world: (FASTA path, mzML
    path, truth of ``library_run_truth``, the run's cycle RTs). Made on the
    CPU so that every machine writes the same bytes: the planted library is
    predicted in float64 (rounded to float32), the mzML is not compressed
    (zlib builds differ in their output)."""
    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.testing.fasta import write_fasta
    from alphadia_torch.testing.mzml_writer import write_mzml
    from alphadia_torch.testing.synthetic import SyntheticConfig, make_run_from_library

    fasta = write_fasta(tmp / "db.fasta", world["n_proteins"], seed=world["fasta_seed"])
    flat = predicted_library([fasta], prediction=_float64_prediction())
    cfg = SyntheticConfig(**{k: v for k, v in world.items() if k not in ("n_proteins", "fasta_seed")})
    spectra = make_run_from_library(flat.precursor_df, flat.fragment_df, cfg)
    raw = tmp / "run.mzML"
    write_mzml(raw, spectra, compress=False)
    return fasta, raw, library_run_truth(flat.precursor_df, cfg), DiaData.from_spectra(spectra).cycle_rt


def library_free_readings(out, truth: dict, cycle_rt, fdr: float = 0.01) -> dict:
    """What phase [10a] gates, from a CLI run's output folder (either
    package's): the identified share (planted targets with a target PSM at
    q <= fdr, by sequence, mods and charge), the false share (accepted
    targets not planted or more than 3 cycles from their apex), targets and
    decoys accepted, the protein groups at 1% protein FDR."""
    from pathlib import Path

    import numpy as np

    from alphadia_torch.utils.parquet import read_parquet

    out = Path(out)
    psm = read_parquet(out / "quant" / "run" / "psm.parquet")
    accepted = psm["qval"] <= fdr
    target = psm["decoy"] == 0
    sel = accepted & target
    row = {(str(s), str(m), int(z)): i for i, (s, m, z) in enumerate(zip(truth["sequence"], truth["mods"], truth["charge"]))}
    rows = np.array([row[(str(s), str(m), int(z))] for s, m, z in zip(psm["sequence"][sel], psm["mods"][sel], psm["charge"][sel])], np.int64)
    planted = truth["_truth_detectable"]
    det = np.nonzero(planted)[0]
    truth_cycle = np.abs(cycle_rt[None, :] - truth["_truth_rt"][rows][:, None]).argmin(1)
    false = ~planted[rows] | (np.abs(psm["frame_center"][sel] - truth_cycle) > 3)
    prec = read_parquet(out / "precursors.parquet")
    return {
        "identified": float(np.isin(det, rows).mean()),
        "false": float(false.mean()) if len(false) else 0.0,
        "targets": int(len(rows)),
        "decoys": int((accepted & ~target).sum()),
        "protein_groups": len(set(prec["pg.name"][prec["precursor.decoy"] == 0].tolist())),
    }


# phase [13a] of ``chip_smoke.py``: the dimethyl-multiplexed search of
# ``tests/e2e/test_multiplex_e2e.py`` at the library-free world's width. The
# 20-protein FASTA of phase [10a], digested with fixed light dimethyl on K
# and every N-terminus (no variable modifications, as the e2e test), the
# packaged models in float64; the run plants channels 0 and 4 (4 at half
# intensity) of ``MultiplexLibrary``; channel 12 (2H(6)) is never planted
MULTIPLEX_MEDIUM = {"Dimethyl@K": "Dimethyl:2H(4)@K", "Dimethyl@Any_N-term": "Dimethyl:2H(4)@Any_N-term"}
MULTIPLEX_HEAVY = {"Dimethyl@K": "Dimethyl:2H(6)@K", "Dimethyl@Any_N-term": "Dimethyl:2H(6)@Any_N-term"}
MULTIPLEX_MAPPING = [
    {"channel_name": 0, "modifications": {}},
    {"channel_name": 4, "modifications": MULTIPLEX_MEDIUM},
    {"channel_name": 12, "modifications": MULTIPLEX_HEAVY},
]
MULTIPLEX_DIGEST = dict(fixed_modifications="Dimethyl@K;Dimethyl@Any_N-term", variable_modifications="")
# the e2e test's overrides (its random state set per reading)
MULTIPLEX_OVERRIDES = {
    "general": {"save_figures": False},
    "calibration": {"batch_size": 200, "optimization_lock_target": 30, "min_steps": 2, "max_steps": 5},
    "search": {"target_ms1_tolerance": 10, "target_ms2_tolerance": 12, "target_rt_tolerance": 60},
    "library_multiplexing": {"enabled": True, "input_channel": 0, "multiplex_mapping": MULTIPLEX_MAPPING},
    "multiplexing": {"enabled": True, "target_channels": "0,4", "decoy_channel": 12, "reference_channel": 0},
    "fdr": {"keep_decoys": False},
    "tpu": {"selection_batch": 256, "scoring_batch": 256},
}


def write_multiplex_inputs(tmp, world: dict = LIBRARY_FREE_WORLD):
    """The base library (``base.hdf``, the port's writer) and the run
    (``run.mzML``, uncompressed) of phase [13a]: (library path, mzML path,
    the planted flat library's precursors, the run's cycle RTs)."""
    import numpy as np

    from alphadia_torch.library.digest import digest_fasta
    from alphadia_torch.library.flatten import FlattenLibrary, InitFlatColumns
    from alphadia_torch.library.harmonize import IsotopeGenerator, PrecursorInitializer
    from alphadia_torch.library.multiplex import MultiplexLibrary
    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.testing.fasta import write_fasta
    from alphadia_torch.testing.mzml_writer import write_mzml
    from alphadia_torch.testing.synthetic import SyntheticConfig, make_run_from_library

    fasta = write_fasta(tmp / "db.fasta", world["n_proteins"], seed=world["fasta_seed"])
    base = digest_fasta([str(fasta)], **MULTIPLEX_DIGEST)
    base = IsotopeGenerator()(_float64_prediction()(PrecursorInitializer()(base)))
    flat = InitFlatColumns()(FlattenLibrary()(MultiplexLibrary(MULTIPLEX_MAPPING[:2])(base.copy())))
    prec, frag = flat.precursor_df, dict(flat.fragment_df)
    scale = np.where(prec["channel"] == 4, np.float32(0.5), np.float32(1.0))
    counts = prec["flat_frag_stop_idx"].astype(np.int64) - prec["flat_frag_start_idx"]
    frag["intensity"] = (frag["intensity"] * np.repeat(scale, counts)).astype(np.float32)
    cfg = SyntheticConfig(**{k: v for k, v in world.items() if k not in ("n_proteins", "fasta_seed")})
    spectra = make_run_from_library(prec, frag, cfg)
    raw = tmp / "run.mzML"
    write_mzml(raw, spectra, compress=False)
    lib_path = tmp / "base.hdf"
    base.save_hdf(lib_path)
    return lib_path, raw, prec, DiaData.from_spectra(spectra).cycle_rt


def library_sha256(path) -> str:
    """sha256 over an HDF library's decoded frames (names, dtypes, bytes;
    text as UTF-8): identity that does not depend on zlib's bytes."""
    import hashlib

    import numpy as np

    from alphadia_torch.library.loader import load_speclib_hdf

    lib = load_speclib_hdf(path)
    h = hashlib.sha256()
    frames = [lib.precursor_df] + ([lib.fragment_df] if hasattr(lib, "fragment_df") else [])
    for frame in frames:
        for k, v in frame.items():
            v = np.asarray(v)
            data = "\0".join(map(str, v.tolist())).encode() if v.dtype == object else np.ascontiguousarray(v).tobytes()
            h.update(k.encode() + v.dtype.str.encode() + data)
    for m in (getattr(lib, "fragment_mz", None), getattr(lib, "fragment_intensity", None)):
        if m is not None:
            h.update(np.ascontiguousarray(m).tobytes())
    return h.hexdigest()


def multiplex_readings(out, fdr: float = 0.01) -> dict:
    """What phase [13a] gates, from a CLI run's output folder: the
    precursors per channel in ``precursors.parquet`` (decoys dropped, as the
    e2e test reads it), the channel-0 and channel-4 sequences in common."""
    from pathlib import Path

    import numpy as np

    from alphadia_torch.utils.parquet import read_parquet

    prec = read_parquet(Path(out) / "precursors.parquet")
    channel = np.asarray(prec["precursor.channel"]).astype(np.int64)
    r = {f"channel_{c}": int((channel == c).sum()) for c in (0, 4, 12)}
    seq = np.asarray(prec["precursor.sequence"]).astype(str)
    s0, s4 = set(seq[channel == 0]), set(seq[channel == 4])
    r["shared_4_of_0"] = len(s0 & s4) / max(len(s4), 1)
    return r


# phase [13b] of ``chip_smoke.py``: the transfer requant. The physics world of
# ``tests/integration/test_transfer_requant.py`` (``testing/physics.py``:
# sequence-determined RT and MS2) over the library-free world's 20-protein
# FASTA: the base library's fragment m/z from the sequences, its RT and MS2
# the physics'; each run plants every fragment of the library (the transfer
# library's MS2 QC takes a precursor whose median fragment correlation over
# the whole b/y space passes 0.5: with the top 12 planted of ~64, none does)
PHYSICS_WORLD = dict(LIBRARY_FREE_WORLD)
PHYSICS_RUN_SEEDS = (101, 202)
PHYSICS_PLANTED_TOP_K = 10**6


def physics_library(fasta_paths, physics=None, prediction=None, **digest_kw):
    """Digest -> prediction (float64 on the CPU) -> the physics' RT
    (``rt_norm``) and MS2 (``b_z1``, ``b_z2``, ``y_z1``, ``y_z2``) ->
    isotopes: the base library (``SpecLibBase``) and its ``PeptidePhysics``."""
    import numpy as np

    from alphadia_torch.library.digest import digest_fasta
    from alphadia_torch.library.harmonize import IsotopeGenerator, PrecursorInitializer
    from alphadia_torch.testing.physics import FRAG_COLS, PeptidePhysics

    physics = physics or PeptidePhysics()
    lib = digest_fasta([str(p) for p in fasta_paths], **digest_kw)
    lib = (prediction or _float64_prediction())(PrecursorInitializer()(lib))
    df = lib.precursor_df
    df["rt_norm"] = physics.rt_norm([str(x) for x in df["sequence"]])
    cols = lib.charged_frag_types
    inten = lib.fragment_intensity.copy()
    for seq, z, a, b in zip(df["sequence"], df["charge"], df["frag_start_idx"], df["frag_stop_idx"]):
        mat = physics.ms2_matrix(str(seq), int(z))
        block = np.zeros((int(b) - int(a), len(cols)), np.float32)
        for j, c in enumerate(cols):
            if c in FRAG_COLS:
                n = min(len(mat), len(block))
                block[:n, j] = mat[:n, FRAG_COLS.index(c)]
        inten[int(a) : int(b)] = block
    lib.fragment_intensity = inten
    return IsotopeGenerator()(lib), physics


def write_transfer_inputs(tmp, world: dict = PHYSICS_WORLD, runs=PHYSICS_RUN_SEEDS,
                          planted_top_k: int = PHYSICS_PLANTED_TOP_K, fasta=None, missed_cleavages=None):
    """The physics world's base library (``physics.hdf``, the port's writer)
    and its runs (``run_<i>.mzML``, uncompressed; one acquisition seed a
    run): (library path, mzML paths, the planted flat library, each run's
    cycle RTs, the physics)."""
    from alphadia_torch.library.flatten import FlattenLibrary, InitFlatColumns
    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.testing.fasta import write_fasta
    from alphadia_torch.testing.mzml_writer import write_mzml
    from alphadia_torch.testing.synthetic import SyntheticConfig, make_run_from_library

    if fasta is None:
        fasta = write_fasta(tmp / "db.fasta", world["n_proteins"], seed=world["fasta_seed"])
    digest_kw = {} if missed_cleavages is None else {"missed_cleavages": missed_cleavages}
    base, physics = physics_library([fasta], **digest_kw)
    truth = InitFlatColumns()(FlattenLibrary(top_k_fragments=planted_top_k, min_fragment_intensity=0.0)(base.copy()))
    cfg = {k: v for k, v in world.items() if k not in ("n_proteins", "fasta_seed")}
    raws, cycle_rts = [], []
    for i, acq in enumerate(runs):
        spectra = make_run_from_library(truth.precursor_df, truth.fragment_df, SyntheticConfig(**cfg, acq_seed=acq))
        raws.append(tmp / f"run_{i}.mzML")
        write_mzml(raws[-1], spectra, compress=False)
        cycle_rts.append(DiaData.from_spectra(spectra).cycle_rt)
    lib_path = tmp / "physics.hdf"
    base.save_hdf(lib_path)
    return lib_path, raws, truth, cycle_rts, physics


# the world of ``tests/integration/test_transfer_requant.py``: four proteins,
# one missed cleavage, the run planting the top 12 fragments of the physics
# MS2; its workflow config
REQUANT_FASTA = """>sp|P001|PROT1 GN=G1
MKWVTFISLLFLFSSAYSRGVFRRDAHKSEVAHRFKDLGEENFKALVLIAFAQYLQQCPFEDHVKLVNEVTEFAK
>sp|P002|PROT2 GN=G2
MTEYKLVVVGAGGVGKSALTIQLIQNHFVDEYDPTIEDSYRKQVVIDGETCLLDILDTAGQEEYSAMRDQYMRTGEGFLCVFAINNTK
>sp|P003|PROT3 GN=G3
MGLSDGEWQLVLNVWGKVEADIPGHGQEVLIRLFKGHPETLEKFDKFKHLKSEDEMKASEDLKKHGATVLTALGGILKKKGHHEAEIKPLAQSHATK
>sp|P004|PROT4 GN=G4
MSKGEELFTGVVPILVELDGDVNGHKFSVSGEGEGDATYGKLTLKFICTTGKLPVPWPTLVTTFSYGVQCFSR
"""
REQUANT_RUN = dict(n_windows=6, n_cycles=300, noise_peaks_per_spectrum=40, seed=5, detectable_fraction=0.9)
REQUANT_CONFIG = {
    "general": {"random_state": 42, "save_figures": False, "input_library_type": "flat"},
    "calibration": {"batch_size": 150, "optimization_lock_target": 30, "min_steps": 2, "max_steps": 6},
    "search": {"target_ms1_tolerance": 10, "target_ms2_tolerance": 12, "target_rt_tolerance": 60},
    "search_initial": {"ms1_tolerance": 25, "ms2_tolerance": 25, "rt_tolerance": 0.5},
    "tpu": {"selection_batch": 256, "scoring_batch": 256},
    "transfer_library": {"enabled": True, "fragment_types": ["b", "y"], "max_charge": 2},
}


def write_requant_inputs(tmp):
    """The run (``requant.npz``) and the searched flat library (decoys) of
    the integration test's physics world, the port's functions throughout:
    (raw path, flat library, physics)."""
    from alphadia_torch.library.decoy import DecoyGenerator
    from alphadia_torch.library.flatten import FlattenLibrary, InitFlatColumns
    from alphadia_torch.rawdata import save_npz
    from alphadia_torch.testing.synthetic import SyntheticConfig, make_run_from_library

    fasta = tmp / "requant.fasta"
    fasta.write_text(REQUANT_FASTA)
    base, physics = physics_library([fasta], missed_cleavages=1)
    truth = InitFlatColumns()(FlattenLibrary()(base.copy()))
    searched = InitFlatColumns()(FlattenLibrary()(DecoyGenerator("diann")(base)))
    raw = tmp / "requant.npz"
    save_npz(raw, make_run_from_library(truth.precursor_df, truth.fragment_df, SyntheticConfig(**REQUANT_RUN)))
    return raw, searched, physics


def requant_checks(physics, precursor: dict, psm: dict, scored: dict, requant_psm: dict, requant_frag: dict) -> dict:
    """The integration test's readings of a requant: PSMs, one row a
    candidate, the medians of fragments a precursor (scored and
    requantified, over the precursors in both), the ``flat_frag_*``
    partition, and the median correlation of the requantified intensities
    with the planted MS2 over the first 40 common precursors."""
    import numpy as np

    from alphadia_torch.testing.physics import FRAG_COLS

    def per_precursor(frag):
        idx, n = np.unique(frag["precursor_idx"], return_counts=True)
        return dict(zip(idx.tolist(), n.tolist()))

    keys = list(zip(requant_psm["precursor_idx"].tolist(), requant_psm["rank"].tolist()))
    per_scored, per_requant = per_precursor(scored), per_precursor(requant_frag)
    common = sorted(set(per_scored) & set(per_requant))
    starts, stops = requant_psm["flat_frag_start_idx"], requant_psm["flat_frag_stop_idx"]
    order = np.argsort(starts)
    s, e = starts[order], stops[order]
    nonempty = e > s
    partition = bool((stops >= starts).all() and (s[nonempty][1:] >= e[nonempty][:-1]).all()
                     and e.max() <= len(requant_frag["precursor_idx"]))
    partition &= all((requant_frag["precursor_idx"][starts[i] : stops[i]] == requant_psm["precursor_idx"][i]).all()
                     for i in range(min(20, len(keys))))
    row = {p: i for i, p in enumerate(precursor["precursor_idx"].tolist())}
    col_of = {(ord(c.split("_z")[0]), int(c.split("_z")[1])): j for j, c in enumerate(FRAG_COLS)}
    corrs = []
    for pidx in common[:40]:
        sub = requant_frag["precursor_idx"] == pidx
        if sub.sum() < 6:
            continue
        mat = physics.ms2_matrix(str(precursor["sequence"][row[pidx]]), int(precursor["charge"][row[pidx]]))
        truth = np.array([
            mat[int(p), col_of[(int(t), int(c))]] if (int(t), int(c)) in col_of and int(p) < len(mat) else 0.0
            for p, t, c in zip(requant_frag["position"][sub], requant_frag["type"][sub], requant_frag["charge"][sub])
        ])
        obs = requant_frag["intensity"][sub]
        if truth.std() > 0 and obs.std() > 0:
            corrs.append(np.corrcoef(truth, obs)[0, 1])
    return {
        "psms": len(psm["precursor_idx"]),
        "duplicate_candidates": len(keys) - len(set(keys)),
        "common_precursors": len(common),
        "scored_median": float(np.median([per_scored[p] for p in common])) if common else 0.0,
        "requant_median": float(np.median([per_requant[p] for p in common])) if common else 0.0,
        "partition": partition,
        "correlated_precursors": len(corrs),
        "median_correlation": float(np.median(corrs)) if corrs else 0.0,
    }


def requant_gates(r: dict) -> list:
    """The integration test's assertions on ``requant_checks``: the names
    of those that fail."""
    failed = []
    for name, ok in (
        ("psms > 30", r["psms"] > 30),
        ("one row a candidate", r["duplicate_candidates"] == 0),
        ("common precursors > 10", r["common_precursors"] > 10),
        ("requant median > 1.5 x scored", r["requant_median"] > 1.5 * r["scored_median"]),
        ("flat_frag_* partition", r["partition"]),
        ("correlated precursors > 8", r["correlated_precursors"] > 8),
        ("median correlation > 0.5", r["median_correlation"] > 0.5),
    ):
        if not ok:
            failed.append(name)
    return failed


def transfer_readings(out, runs: int = 2) -> dict:
    """What phase [13b] gates, from a CLI run's output folder: per run the
    rows of ``frag.parquet`` and ``frag.transfer.parquet`` and the median
    fragments a precursor in each; the transfer library's PSMs, fragments
    and precursors (0 where none passed the MS2 QC and none was written)."""
    from pathlib import Path

    import numpy as np

    from alphadia_torch.utils.parquet import read_parquet

    out = Path(out)
    r = {}
    for i in range(runs):
        for name, key in (("frag.parquet", "scored"), ("frag.transfer.parquet", "transfer")):
            f = read_parquet(out / "quant" / f"run_{i}" / name)
            _, per = np.unique(f["precursor_idx"], return_counts=True)
            r[f"{key}_rows_run_{i}"] = int(len(f["precursor_idx"]))
            r[f"{key}_median_run_{i}"] = float(np.median(per)) if len(per) else 0.0
    if not (out / "speclib.transfer.parquet").exists():  # no PSM passed the MS2 QC
        return {**r, "transfer_psms": 0, "transfer_fragments": 0, "transfer_precursors": 0}
    psm = read_parquet(out / "speclib.transfer.parquet")
    frag = read_parquet(out / "speclib.transfer.fragments.parquet")
    r["transfer_psms"] = int(len(psm["precursor_idx"]))
    r["transfer_fragments"] = int(len(frag["precursor_idx"]))
    r["transfer_precursors"] = int(len(np.unique(psm["mod_seq_charge_hash"])))
    return r


# phase [11c] of ``chip_smoke.py``: the 4D quarter world of phase [8]
# (6,250 peptides + decoys, 3 windows, 600 cycles, with mobility, from
# sequences) written as a Bruker ``.d`` by the port's writer, its targets as
# a TSV transition list, searched through the CLI at calibration batch 2,000
D_WORLD = dict(
    n_peptides=6250, n_windows=3, n_cycles=600, noise_peaks_per_spectrum=80, seed=5, with_mobility=True,
    from_sequence=True,
)
D_BATCH = 2000


def write_d_inputs(tmp, world: dict = D_WORLD, **writer_kw):
    """A seeded world (with one decoy a target, as ``chip_smoke.make_spectra``
    makes it) as a ``.d`` directory of the port's TDF writer and a TSV
    transition list of its targets: (``.d`` path, library path, targets,
    the run's cycle RTs, the spectra written)."""
    import numpy as np

    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
    from alphadia_torch.testing.tdf_writer import spectrum_data_to_tdf
    from alphadia_torch.testing.tsv_library import write_transition_list

    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(**world))
    prec, frag = add_synthetic_decoys(prec, frag)
    targets = np.nonzero(prec["decoy"] == 0)[0]
    truth = {k: v[targets] for k, v in prec.items()}
    d_path, lib_path = spectrum_data_to_tdf(spectra, tmp / "run_4d.d", **writer_kw), tmp / "lib.tsv"
    write_transition_list(lib_path, truth, frag)
    return d_path, lib_path, truth, DiaData.from_spectra(spectra).cycle_rt, spectra


def d_sha256(d_path) -> str:
    """sha256 of a ``.d`` directory's content: the bytes of
    ``analysis.tdf_bin`` and the rows of every table of ``analysis.tdf``
    (SQLite's file bytes carry its library's version)."""
    import hashlib
    import sqlite3
    from pathlib import Path

    d_path = Path(d_path)
    h = hashlib.sha256((d_path / "analysis.tdf_bin").read_bytes())
    con = sqlite3.connect(f"file:{d_path / 'analysis.tdf'}?mode=ro", uri=True)
    try:
        for (table,) in con.execute("SELECT name FROM sqlite_master WHERE type='table' ORDER BY name").fetchall():
            h.update(table.encode())
            for row in con.execute(f"SELECT * FROM {table} ORDER BY rowid"):
                h.update(repr(row).encode())
    finally:
        con.close()
    return h.hexdigest()


def d_readings(out, truth: dict, cycle_rt, fdr: float = 0.01) -> dict:
    """What phase [11c] gates, from a CLI run's output folder on the run
    ``run_4d`` (either package's files): the identified and false shares at
    1% FDR (``search_id_shares``), the final RT tolerance, the protein groups
    at 1% protein FDR, and the median absolute error of the observed
    mobility of the accepted targets against the generator's truth."""
    from pathlib import Path

    import numpy as np

    from alphadia_torch.utils.parquet import read_parquet
    from alphadia_torch.utils.tsv import read_tsv

    out = Path(out)
    psm = read_parquet(out / "quant" / "run_4d" / "psm.parquet")
    identified, false, n_t, n_d = search_id_shares(cycle_rt, truth, psm, fdr)
    prec = read_parquet(out / "precursors.parquet")
    row = {(str(s), int(z)): i for i, (s, z) in enumerate(zip(truth["sequence"], truth["charge"]))}
    sel = (prec["precursor.decoy"] == 0) & (prec["precursor.qval"] <= fdr)
    rows = [row[(str(s), int(z))] for s, z in zip(prec["precursor.sequence"][sel], prec["precursor.charge"][sel])]
    mob_err = np.abs(prec["precursor.mobility.observed"][sel] - truth["_truth_mobility"][np.array(rows, np.int64)])
    return {
        "identified": identified, "false": false, "targets": n_t, "decoys": n_d,
        "rt_error": float(read_tsv(out / "stat.tsv")["optimization.rt_error"][0]),
        "protein_groups": len(set(prec["pg.name"][prec["precursor.decoy"] == 0].tolist())),
        "mobility_error_median": float(np.median(mob_err)) if len(mob_err) else float("nan"),
    }


def tdf_quantized(spectra, mz_range=(100.0, 1700.0), tof_max_index=1_600_000, im_range=(0.5, 1.6), n_scans=927):
    """What reading back ``spectrum_data_to_tdf(spectra)`` (at these
    defaults, one window a frame) must give, from the input through the
    reader's converters: each peak's m/z and 1/K0 to the nearest tof index
    and scan, the peaks of one (scan, tof) cell of a spectrum summed
    (intensities rounded, at least 1), each spectrum in scan-major order
    sorted stably by the converted m/z. Returns (the expected
    ``SpectrumData``, the largest m/z error in ppm of any input peak, the
    largest 1/K0 error of those whose scan lies on the scan grid, and the
    count of those off it, which the writer puts on the first or last
    scan)."""
    import numpy as np

    from alphadia_torch.rawdata.bruker_tdf import ScanImConverter, TofMzConverter
    from alphadia_torch.rawdata.source import SpectrumData

    tof2mz, scan2im = TofMzConverter(*mz_range, tof_max_index), ScanImConverter(*im_range, n_scans)
    counts = (spectra.peak_stop_idx - spectra.peak_start_idx).astype(np.int64)
    spec = np.repeat(np.arange(spectra.n_spectra, dtype=np.int64), counts)
    src = np.repeat(spectra.peak_start_idx - (np.cumsum(counts) - counts), counts) + np.arange(int(counts.sum()))
    mz = spectra.mz[src]
    tof = np.round((np.sqrt(mz.astype(np.float64)) - tof2mz.intercept) / tof2mz.slope).astype(np.int64)
    im = spectra.mobility[src].astype(np.float64)
    raw_scan = np.round((im - scan2im.intercept) / scan2im.slope)
    inside = (raw_scan >= 0) & (raw_scan <= n_scans - 1)
    scan = np.clip(raw_scan, 0, n_scans - 1).astype(np.int64)
    worst_ppm = float(np.max(np.abs(tof2mz(tof).astype(np.float64) / mz - 1.0)) * 1e6) if len(mz) else 0.0
    worst_im = float(np.max(np.abs(scan2im(scan).astype(np.float64) - im)[inside])) if inside.any() else 0.0
    inten = np.maximum(np.round(spectra.intensity[src]), 1).astype(np.int64)
    order = np.lexsort((tof, scan, spec))
    spec, scan, tof, inten = spec[order], scan[order], tof[order], inten[order]
    first = np.nonzero(np.r_[True, (spec[1:] != spec[:-1]) | (scan[1:] != scan[:-1]) | (tof[1:] != tof[:-1])])[0]
    inten = np.add.reduceat(inten, first)
    spec, scan, tof = spec[first], scan[first], tof[first]
    mz_q = tof2mz(tof)
    order = np.lexsort((mz_q, spec))
    n = np.bincount(spec, minlength=spectra.n_spectra).astype(np.int64)
    start = np.cumsum(n) - n
    expected = SpectrumData(
        rt=spectra.rt, ms_level=spectra.ms_level, isolation_lower_mz=spectra.isolation_lower_mz,
        isolation_upper_mz=spectra.isolation_upper_mz, peak_start_idx=start, peak_stop_idx=start + n,
        mz=mz_q[order], intensity=inten[order].astype(np.float32), mobility=scan2im(scan[order]),
    )
    return expected, worst_ppm, worst_im, int((~inside).sum())


def same_spectra(a, b) -> bool:
    """Every array of two ``SpectrumData`` equal in dtype and bit for bit."""
    import numpy as np

    fields = ("rt", "ms_level", "isolation_lower_mz", "isolation_upper_mz", "peak_start_idx", "peak_stop_idx", "mz",
              "intensity", "mobility")
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None):
            return False
        if x is not None and (x.dtype != y.dtype or not np.array_equal(x, y)):
            return False
    return True


# phase [14] of ``chip_smoke.py``: the three-step plan (transfer step ->
# library step -> MBR step) library-free on the physics world's FASTA and
# two runs (``write_transfer_inputs``), the transfer step predicting with the
# packaged models and the later steps with the ones it tuned
def multistep_argv(out, raws, fasta, state: int, profile_dir=None, mbr: bool = True) -> list:
    import json

    cfg = {"general": {"random_state": state, "save_figures": False, "transfer_step_enabled": True,
                       "mbr_step_enabled": mbr}, "library_prediction": {"enabled": True}}
    argv = ["-o", str(out), *[a for r in raws for a in ("-f", str(r))], "--fasta", str(fasta),
            "--config-dict", json.dumps(cfg)]
    return argv + (["--profile-dir", str(profile_dir)] if profile_dir else [])


def physics_truth(planted) -> dict:
    """``library_run_truth`` of the physics world's runs (both plant the
    same precursors: only their acquisition seeds differ)."""
    from alphadia_torch.testing.synthetic import SyntheticConfig

    cfg = SyntheticConfig(**{k: v for k, v in PHYSICS_WORLD.items() if k not in ("n_proteins", "fasta_seed")})
    return library_run_truth(planted.precursor_df, cfg)


def planted_shares(psm: dict, truth: dict, cycle_rt, fdr: float = 0.01) -> tuple[float, float]:
    """(identified, false) of a run's PSMs as ``library_free_readings``
    reads them: planted targets with a target PSM at q <= fdr, by sequence,
    mods and charge; accepted targets not planted or more than 3 cycles from
    their apex."""
    import numpy as np

    sel = (psm["qval"] <= fdr) & (psm["decoy"] == 0)
    row = {(str(s), str(m), int(z)): i for i, (s, m, z) in enumerate(zip(truth["sequence"], truth["mods"], truth["charge"]))}
    rows = np.array([row.get((str(s), str(m), int(z)), -1) for s, m, z in
                     zip(psm["sequence"][sel], psm["mods"][sel], psm["charge"][sel])], np.int64)
    known = rows >= 0
    planted = truth["_truth_detectable"]
    det = np.nonzero(planted)[0]
    truth_cycle = np.abs(cycle_rt[None, :] - truth["_truth_rt"][rows[known]][:, None]).argmin(1)
    false = np.ones(len(rows), bool)
    false[known] = ~planted[rows[known]] | (np.abs(psm["frame_center"][sel][known] - truth_cycle) > 3)
    return float(np.isin(det, rows).mean()), float(false.mean()) if len(false) else 0.0


def multistep_readings(out, truth: dict, cycle_rts: list) -> dict:
    """What phase [14] gates, from the plan's output folder (either
    package's): the transfer library's PSMs and precursors; the fitted
    models' RT R², RT 95th-percentile error, charge accuracy and MS2 spectral
    angle (``stats.transfer.tsv``); per step (library, MBR) and run the
    identified and false shares and the protein groups; the MBR library's
    precursors."""
    from pathlib import Path

    import numpy as np

    from alphadia_torch.library.loader import load_speclib_hdf
    from alphadia_torch.utils.parquet import read_parquet
    from alphadia_torch.utils.tsv import read_tsv

    out = Path(out)
    r = {}
    psm = read_parquet(out / "transfer" / "speclib.transfer.parquet")
    r["transfer_psms"] = int(len(psm["precursor_idx"]))
    r["transfer_precursors"] = int(len(np.unique(psm["mod_seq_charge_hash"])))
    stats = read_tsv(out / "transfer" / "stats.transfer.tsv")
    for k in ("rt_r2", "rt_abs_error_95", "charge_accuracy", "ms2_spectral_angle"):
        r[k] = float(stats[k][0])
    for step, d in (("library", out / "library"), ("mbr", out)):
        for i, cycle_rt in enumerate(cycle_rts):
            run = read_parquet(d / "quant" / f"run_{i}" / "psm.parquet")
            r[f"{step}_identified_run_{i}"], r[f"{step}_false_run_{i}"] = planted_shares(run, truth, cycle_rt)
        prec = read_parquet(d / "precursors.parquet")
        r[f"{step}_protein_groups"] = len(set(prec["pg.name"][prec["precursor.decoy"] == 0].tolist()))
    r["mbr_library_precursors"] = len(load_speclib_hdf(out / "library" / "speclib.mbr.hdf").precursor_df["precursor_idx"])
    return r
