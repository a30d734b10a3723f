#!/usr/bin/env python3
"""Drive the PyTorch port's extraction path on one CUDA card.

    python3 chip_smoke.py              # full width
    python3 chip_smoke.py --profile    # also trace one pass of the main path

Two paths, each of three passes: candidate selection (rt_tolerance 60 s)
-> scoring (bfloat16) -> a wide-window selection (450 s, coarsened to
stride 2). The 3D path runs the synthetic DIA run of the JAX package's
benchmark (6000 peptides + decoys = 12,000 precursors, 12 windows, 600
cycles); the 4D path a timsTOF-like run of the same generator with ion
mobility in 8 scan bins (25,000 peptides + decoys = 50,000 precursors).

Phases, in order; any failure exits non-zero:

1. the card: name, count, and ``nvidia-smi`` name and power limit;
2. build the XIC kernel (``alphadia_torch/csrc/xic.cu``) with nvcc;
3. the kernel against its plain PyTorch version on the card, on every
   launch of a recorded warm-up of both paths: variants (a) intensity
   only, (b) with the m/z plane as a delta, (d) the coarse view on the 3D
   path, (c) the scan-window crop on every 4D scoring batch; every call of
   the scan-resolved kernel (the 4D extractions) held to its plain version
   in the same way, here and wherever a phase records the kernels' calls;
   and each path on the card against the same path on the CPU on a small
   world, scoring in float32 and in bfloat16;
4. both paths at full width, the kernels' launches counted per pass (the
   scan-resolved kernel's on the 4D passes, and on them only); the
   truth, PSM (and, 4D, scan-centre) shares; then more timed passes for
   the spread (``--profile``: one traced pass of each path);
5. the kernel alone (CUDA events) on each recorded launch, back to back and
   with the L2 flushed before each run, beside the plain version, the least
   time the card needs for the bytes the function must move, and the bytes
   the kernel's loads, copies and stores cover; (b) the scan-resolved kernel
   of the 4D extractions (``csrc/scan_cells.cu``) alone on a store at the 4D
   benchmark cell's density and at its launch shapes, warm and L2-flushed,
   beside its byte bound and the plain version's time and peak memory,
   each launch held to the plain version;
6. IDs at 1% FDR, on both worlds: ``PipelinedExtraction`` against the
   sequential drivers (walls, launches, the same candidates and PSMs), then
   ``FDRManager.fit_predict`` on the pipelined PSMs (the network fitted on
   the card; its steps timed; the identified and the realised false share
   of the IDs at 1% FDR gated against the JAX package's own readings); on
   the 4D world the RT-windowed search against the whole run (the same
   PSMs, peak memory); the classifier on the card against the CPU on a
   small world. Phase [3] records and checks the kernel launches of these
   drivers too;
7. the per-run workflow on both worlds: each run written as a ``.npz`` raw
   file and read back through ``RawFileManager``, then
   ``PeptideCentricWorkflow`` ``load`` -> ``search_parameter_optimization``
   (the calibration and tolerance loop, pipelined selection and scoring and
   an FDR fit a step) -> ``extraction``, at the port's default config; per
   step the optimizers, their tolerances, the batch, the targets at 1% FDR
   and the walls; the final tolerances and calibration; the kernel's
   launches and summed device time, each pass's first launch of every step
   and of the final extraction held against the plain version; the IDs at
   1% FDR and the fragment m/z calibration gated against the JAX package's
   readings; and the workflow on the card against the same workflow on the
   CPU on the small world of the CPU tests;
8. the search step on both worlds: each run written as ``.mzML`` (per-peak
   mobility arrays on 4D) and read back through ``load_raw_file`` (every
   array equal bit for bit), its targets as a TSV transition list, then
   ``SearchStep(out, config).run()`` at the default config: the library
   built from the TSV (parse, harmonize, hashing, decoys, flatten timed),
   the workflow of phase [7], ``psm.parquet`` and ``frag.parquet`` (read
   back equal to the step's frames) and ``frozen_config.yaml``; the IDs at
   1% FDR gated against the JAX package's readings of the same kind of
   inputs, the kernel's launches counted and each pass's first launch of
   every step and of the final extraction held against the plain version;
9. the CLI across two runs: ``alphadia-torch`` (``cli.run``) on two runs
   of the search step's quarter 3D world written as mzML, with a TSV
   library whose protein groups overlap, at the default config on the
   card: the library build, each run's search step (the mzML reader a
   parse, its spectra cache written; the single step on run 0 after it a
   cache read) and the cross-run outputs timed (``SearchPlanOutput.build``:
   read, grouping, protein FDR with its MLP fit, LFQ per level, writes);
   the tables and the MBR library (``speclib.mbr.hdf``) read back; the
   kernel's launches per run, each
   pass's first launch of every step held against the plain version; the
   IDs per run, the protein groups, the LFQ groups and the run-to-run
   ratio gated against the JAX package's CLI on the same inputs, the
   tolerances against the card's own search step on the first run;
10. library-free search: (a) ``alphadia-torch -f run.mzML --fasta
   db.fasta`` with ``library_prediction.enabled`` on the card, the inputs
   made on the host (a seeded FASTA of 20 proteins, the run planted with
   the library its digest and the packaged models predict) and checked by
   sha256 against those of the JAX readings: the digest, each property
   model's predict (device ms from CUDA events), the rest of the library
   build, the search step and the outputs timed; the predicted library on
   the card against the CPU's; the kernel's launches, each pass's first
   launch of every step held against the plain version; the IDs at 1% FDR
   and the protein groups gated against the JAX package's CLI on the same
   files; (b) prediction at proteome scale: a seeded FASTA of a quarter
   of the human proteome (5,100 of 20,400 proteins) digested, the four
   models on its leading 2**18 precursors on the card
   (walls, device ms, precursors/s, peak memory, the card against the CPU
   on the first 20,000), ``SimplePrediction.forward`` on the whole digest
   or the largest leading share its host stages fit into the phase's 40 s
   aim;
11. Bruker ``.d`` input: (a) the zstd decoder (``csrc/zstd.cpp``) built
   with the host's C++ compiler and held to the committed fixture (the
   JAX writer's ``.d`` read with the sha256 of the JAX reader's arrays, the
   frame payloads at zstd levels -5, 1 and 19 with their sha256), its rate
   on 1 and on every host thread; (b) [8]'s full 4D world from sequences
   written by the port's TDF writer and read back equal to the input
   quantized to tof index and scan (the reader's walls split into SQLite,
   decode and window split); (c) ``alphadia-torch -f run_4d.d -l lib.tsv``
   on phase [8]'s 4D quarter world on the card: the walls, the kernel's
   launches (each pass's first launch of every step held against the plain
   version), the IDs, the final RT tolerance, the protein groups and the
   observed mobility gated against the JAX package's CLI on the same files;
12. HDF: (a) the committed fixture (h5py's files through the JAX
   package's writers: spectra caches 3D and 4D, a base and a flat library,
   an alphaRaw file with vlen strings, shuffle+deflate and LZF) read by
   the port's reader with the sha256 and attributes of h5py's reading,
   each written again by the port's writer and read back the same; (b) an
   alphaRaw ``.hdf`` of 50,000,000 peaks (the 3D world tiled in RT) and a
   flat library of 1,000,000 precursors x 12 fragments written and read
   back equal on 1 and on every host thread (MB/s, rows/s), cut where a
   probe says the phase would pass its 15 s aim; (c) ``alphadia-torch``
   with the MBR step (library step -> ``speclib.mbr.hdf`` -> MBR step) on
   phase [9]'s two runs as alphaRaw ``.hdf`` with ``save_library`` and
   ``save_flat_library``: each step's wall and its outputs', the kernel's
   launches per step (each pass's first launch of every step held against
   the plain version), the saved libraries read back equal to the frames
   in memory, the IDs per run, the protein groups and the MBR library's
   size gated against the JAX package's CLI on the same inputs;
13. requantification: (a) the dimethyl-multiplexed search (channels 0, 4
   and 12 of the 20-protein FASTA's digest; 0 and 4 planted) through
   ``alphadia-torch`` with ``library_multiplexing``, at the default
   ``tpu.gather_slab`` and at 2,048, the IDs per channel gated against the
   JAX package's CLI on the same files, then
   ``PeptideCentricWorkflow.requantify`` (the multiplexing handler) on the
   run's workflow; (b) ``transfer_library.enabled`` on the two runs of a
   physics world (every fragment planted): the transfer requant of each
   run over the whole b/y space (Q up to 256 fragments a query), the
   ``frag.transfer.parquet`` writes and ``_build_transfer_library`` timed,
   the requant's fragment space and the transfer library's size gated
   against the JAX CLI's, no fallback to the scored set; then the physics
   world of the JAX package's requant integration test through the
   workflow, gated on its assertions. Every launch of the three requants
   is held against the plain version (per pass B, Q, W, variants, errors,
   device ms and bound). In phases [7]-[13] each search pass's first
   launch and then its later ones (overflowing slabs first, the rest in a
   seeded order) are held against the plain version, within 60 s of
   plain-version time in all;
14. the three-step plan: ``alphadia-torch`` with the transfer step and
   the MBR step, library-free on [13b]'s FASTA and two runs (the transfer
   step predicts with the packaged models, fine-tunes the four property
   models on its transfer library on the card, and the library step
   predicts with them): each step's wall and launches (its search passes
   held against the plain version as in [7]-[13], every launch of the
   transfer requant), each model's fit (epochs, ms a step), the transfer
   library's size, the models' metrics, the IDs per run and the protein
   groups of the library and MBR steps and the MBR library's size gated
   against the JAX package's CLI on the same inputs, ``models.pkl`` read
   again predicting within 1e-5 of the live models; then the transfer
   step's search and fits again on one run, with a short calibration
   loop, through ``alphadia-torch --profile-dir``: its trace holds the
   kernel's CUDA events and the workflow's ``alphadia_torch.<phase>``
   spans;
15. several cards and processes, on the one card: (a) every recorded launch
   of phase [3] through the sharded route (``parallel/shard_ops.
   extract_xic_cuda_sharded``) over the card named 2 and 4 times, equal to
   the unsharded kernel at atol 0 and held to the plain version, per pass
   the sharded and unsharded device ms beside the bound; (b) selection and
   scoring with ``mesh_devices`` 2 over the card named twice, on the 3D
   world and [8]'s 4D quarter world, against one device (the same
   candidates and PSMs, every launch through the route), then each of the
   drivers' launches run again alone and held to the plain version, per
   pass the sharded drivers' kernel ms beside one device's and the bound
   (the ``xic_sharded`` entry of the kernels line); (c) ``alphadia-torch``
   on [9]'s runs as two processes of one ``gloo`` group on the card, in
   ``torchrun``'s and in the JAX package's environment (each searched one
   run, process 0 built the outputs once, process 1 returned after them;
   IDs and groups in [9]'s band; the PSMs against [9]'s one process); (d)
   ``general.fail_fast`` with rank 1's file unreadable: both end, rank 1
   with one process's exit code for that file;
16. figures and the GUI: (a) the kernel debug plots on the card
   (``search/plotting.debug_candidates`` on the 3D world's best candidates
   of eight detectable targets after the port's selection: two launches of
   the kernel, counted and each held against the plain version; its 16
   PNGs and ``plot_dia_cycle`` of both worlds read back with the port's PNG
   reader at their pixel sizes and with their series' colours; ms per
   figure); (b) each run's ``quant/run_<i>/figures/fdr.png`` of phase [9]
   (``general.save_figures`` at its default, true) read back at 1080 x 420
   with the target and decoy colours, ``_plot_fdr``'s calls a run, ms a
   call and share of the run's wall; (c) the port's GUI server
   (``gui/server.py``) on a loopback port in a thread: a wrong token and a
   foreign Host refused, the schema, browse, a search of [9]'s run 0
   launched through ``/api/run`` as a process of its own on the card until
   ``done``, its results summary against ``precursors.parquet``, its
   ``fdr.png`` listed and served byte for byte, a path outside the run
   history refused, a second run cancelled;
17. the peak-store builder and the two trainers: (a) the C++ builder
   (``csrc/peakstore.cpp``, built in phase [2] with the host's C++
   compiler; every raw file's ``DiaData`` uses it) against its numpy
   version on both worlds and [8]'s 4D quarter world, every array equal at
   atol 0 on 1 and on every host thread, the walls and peaks per second of
   both; the C++ builder alone on a 50,000,000-peak run (the 3D world tiled
   in RT), the numpy builder at the largest size that fits a 5 s aim; (b)
   ``alphadia_torch.scripts.train_default_classifier`` on the card at its
   full corpora: every XIC launch of its nine searches counted and held
   against the plain version, ``ea4b0fe1c1f77109.pkl`` written and read
   back, the warm-start gate, the separation and the held-out IDs within
   the port's spread across random states of JAX's readings; (c)
   ``train_property_models`` at the shipped widths on a third of the corpus
   and 20 of the 80 epochs (the script's time): each fit's wall, epochs,
   steps and ms a step, every metric and gate reading against JAX's at the
   same cut;
18. a peak store past 2**31 entries, the kernel's int64 cell index: (a)
   the stores of [5]'s launches placed on the card behind 2**31 filler
   rows (25.8 GB, made there with ``torch.full``) and each launch of [5]
   again with its index widened to int64 and moved past 2**31: equal at
   atol 0 to the same launch with the int32 index at offset 0, held to the
   plain version at the offset at [3]'s tolerances; per pass both
   instantiations' device ms (in turns) and bounds, beside [5]'s; (b) both
   main paths of [4] from a ``DiaData`` whose index is widened to int64:
   [4]'s candidates, every PSM feature within ``FEATURE_REL_TOL``; the
   device memory freed;
19. the ``{"kernels": [...]}`` line (``xic``: the launches of phases
   [4]-[14], [16a] and [17b]; ``scan_cells``: the scan-resolved kernel's
   launches recorded on the main paths of [3] (the warm-up of [4]'s and
   [6]'s paths), [7]-[14], [15b], [16a] and [17b], each held to the plain
   version, timed on [5b]'s; ``xic_sharded``: those of [15b]'s sharded
   drivers; ``xic_index64``: the int64 instantiation's launches on [18b]'s
   main paths, timed on [18a]'s; the processes of [15c], [15d] and [16c]
   count in none), then the card's name and power limit, then the
   ``{"ok": true, ...}`` line last.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the worlds' sizes, and the repetitions of the timings
N_PEPTIDES = 6000
N_PEPTIDES_4D = 25000
N_SCAN_BINS = 8
N_CYCLES = 600
REPEATS = 5  # timed passes of the 3D path after the counted one
REPEATS_4D = 3
SCAN_BATCH = 4096  # the 4D drivers' batch cap
KERNEL_REPS = 20
PLAIN_REPS = 3
FLUSH_BYTES = 64 * 2**20  # written before each L2-flushed run: above the 50 MB L2
KERNEL_PIECE = 128  # peaks of one piece that the kernel stages (csrc/xic.cu kPiece)
# kernel vs plain (rtol, atol): intensities; the m/z plane as absolute m/z;
# the m/z plane as a delta from the query centre, whose values lie within
# +-tol_ppm * m/z (~1e-2 Da), so its atol sits far below a typical delta
TOL_INTENSITY = (1e-5, 1e-3)
TOL_MZ_ABSOLUTE = (1e-5, 1e-2)
TOL_MZ_DELTA = (1e-5, 1e-6)
# share of detectable targets whose best candidate lies within 3 cycles of
# the true apex, and share of them with a PSM: the bench world reads 1.0
# for each, and so do the JAX package's 4D drivers on a small 4D world of
# the generator, so these bounds allow a few in a thousand to move
TRUTH_SHARE_MIN = 0.995
PSM_SHARE_MIN = 0.995
# ... except the 4D wide-window (450 s, stride 2) pass: at the 4D world's
# per-window density the JAX package's own 4D drivers read 0.9347 there
# (`PYTHONPATH=. python tests/test_torch_slice_4d.py --peptides 6250
# --windows 3`, on the CPU: a quarter of the world, 3 windows instead of 12;
# candidates identical to the port's), so the gate is that less 0.005
TRUTH_SHARE_WIDE_4D_MIN = 0.9297
# phase [6]: share of paired PSM feature values within FEATURE_REL_TOL
# (pipelined against sequential, RT-windowed against the whole run)
FEATURE_MATCH_MIN = 0.99
RT_WINDOWS = 4
# IDs at 1% FDR (phase [6]), per world: the share of detectable targets
# identified, and the share of accepted targets whose PSM lies more than 3
# cycles from the true apex. The JAX package's drivers and FDRManager read,
# on the CPU at a quarter of each world (3 isolation windows instead of 12,
# the same density per window): 3D identified 1.0000, false 0.0718
# (`PYTHONPATH=. python tests/test_torch_slice_fdr.py --peptides 1500
# --windows 3`); 4D identified 1.0000, false 0.0270 (`... --peptides 6250
# --windows 3 --mobility`). Gates: identified at least that less 0.005; the
# false share at most 0.02, or that reading plus 0.005 where it is higher
IDENTIFIED_MIN = {"": 0.995, "_4d": 0.995}
FALSE_MAX = {"": 0.0768, "_4d": 0.0320}
# one classifier state on the card and on the CPU; two independent fits
CLASSIFIER_PROBA_TOL = 1e-5
FIT_JACCARD_MIN = 0.95
# the path on the card against the path on the CPU, on a small world
CANDIDATE_MATCH_MIN = 0.99
FEATURE_REL_TOL = 1e-2
# bfloat16 scoring, card against CPU: the JAX package's bf16 tolerances
# (tests/unit/test_scoring_bf16.py) on each feature's median deviation
# relative to max(|value|, 1), the mass errors in ppm; and nine in ten
# values within FEATURE_REL_TOL, as the CPU tests hold the port to JAX
MASS_ERRORS = (
    "weighted_mass_deviation", "weighted_mass_error", "top_3_ms2_mass_error",
    "mean_ms2_mass_error", "mean_overlapping_mass_error",
)
BF16_TOL = dict(
    {k: 0.25 for k in MASS_ERRORS}, rt_observed=2e-3, mz_observed=1e-3,
    delta_frame_peak=0.05, base_width_rt=0.05, diff_b_y_ion_intensity=0.06,
)
BF16_TOL_DEFAULT = 0.02
DEVICE = "cuda"
# phase [7], the workflow: the run's seed, and the JAX package's workflow on
# the CPU at a quarter of each world (3 isolation windows instead of 12, the
# same density a window, the default config): 3D identified 1.0000, false
# 0.0367, fragment m/z calibration 0.0137 ppm from the planted bias
# (`PYTHONPATH=. python tests/test_torch_workflow.py --peptides 1500
# --windows 3`); 4D identified 0.9929, false 0.0206, bias 0.0076 ppm (`...
# --peptides 6250 --windows 3 --mobility --batch-size 2000`). The 4D reading
# scales calibration.batch_size with the world, so that the optimization
# steps search the same share of the library as on the 4D world here (8,000
# of 25,000 elution groups); at 8,000 they search the whole quarter world,
# and JAX reads 1.0000 there. The 3D world's steps search the whole library
# either way. Gates: identified at least that less 0.005; false at most
# 0.02, or that plus 0.005 where it is higher; the bias at most that plus
# 0.5 ppm
WF_RANDOM_STATE = 0
WF_IDENTIFIED_MIN = {"": 0.995, "_4d": 0.9879}
WF_FALSE_MAX = {"": 0.0417, "_4d": 0.0256}
WF_BIAS_MAX_PPM = {"": 0.5137, "_4d": 0.5076}
# phase [8], the search step from an mzML file and a TSV library, on the
# worlds made from sequences (SyntheticConfig(from_sequence=True), so that
# the library's sequence-derived decoys fall in their targets' windows and
# compete): the JAX package's SearchStep on the CPU at a quarter of each
# world (3 isolation windows instead of 12, the same density a window, the
# default config, the same inputs made the same way) at random states 0, 1
# and 2. One state does not make a reading here: the automatic RT
# optimizer proposes 1.1 times the 0.5 / 99.5 percentiles of the RT
# residuals, which lie among the few accepted IDs off their apex or not,
# and the final RT tolerance and the false share follow. 3D identified
# 1.0000 / 0.9992 / 0.9984, false 0.0164 / 0.0411 / 0.0626, RT tolerance
# 29.2016 / 194.7021 / 195.7823 s (`PYTHONPATH=. python
# tests/test_torch_search_step.py --peptides 1500 --windows 3
# --random-state N`); 4D identified 0.8557 / 0.8610 / 0.8634, false 0.0368
# / 0.0424 / 0.0459, RT tolerance 236.7987 / 284.5975 / 323.4957 s (`...
# --peptides 6250 --windows 3 --mobility --batch-size 2000 --random-state
# N`). Gates: identified at least the least of them less 0.005; false at
# most 0.02, or the largest plus 0.005 where that is higher; the RT
# tolerance at most 1.25 times the largest, below its start of 449.25 s, so
# that a calibration that never moves fails. The 4D search step runs on
# that quarter world itself (6,250 peptides, 3 windows, calibration batch
# 2,000): with decoys from sequences a 4D world of 12 windows, 50 m/z wide,
# identifies 0.009 less than its quarter, whose windows are 200 m/z wide
# (the port on the card, random states 0-2, `tests/
# torch_search_step_readings.py`), so the quarter's reading does not hold
# at full width. The 3D step stays at full width (0.003 less there)
SS_IDENTIFIED_MIN = {"": 0.9934, "_4d": 0.8507}
SS_FALSE_MAX = {"": 0.0676, "_4d": 0.0509}
SS_RT_ERROR_MAX = {"": 244.7279, "_4d": 404.3696}
SS_BATCH_4D = 2000
# the workflow on the card against the CPU, on the 3D world of the CPU tests
# (tests/torch_workflow_worlds.py)
WF_TOL_REL = 0.05
# the launches held against the plain version in phases [7]-[13] beyond each
# pass's first (launches_against_plain): those with overflowing slabs first,
# then the rest in the order SAMPLE_SEED draws, within SAMPLE_PLAIN_BUDGET_S
# of plain-version time in all (on the H100 ~4 ms a launch, so every
# launch of the script fits)
SAMPLE_SEED = 13
SAMPLE_PLAIN_BUDGET_S = 60.0
PLAIN_SAMPLES = {"spent_s": 0.0, "held": 0, "launches": 0}
WF_JACCARD_MIN = 0.95


def replaced_kernel(root: Path) -> str:
    """``file:line`` of the Pallas kernel that ``csrc/xic.cu`` replaces, read
    from the JAX package in this checkout (which the port never imports)."""
    for path in sorted(root.glob("*/ops/xic_pallas.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if line.startswith("def _xic_kernel("):
                return f"{path.relative_to(root)}:{i}"
    raise FileNotFoundError("the Pallas XIC kernel is not in this checkout")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# worlds and the main path
# ---------------------------------------------------------------------------
def make_spectra(n_peptides, n_cycles, seed=5, n_windows=12, noise=80, **kw):
    """A seeded run of the generator with one decoy per target: (spectra,
    precursors, fragments)."""
    from alphadia_torch.testing.synthetic import (
        SyntheticConfig,
        add_synthetic_decoys,
        make_synthetic_dia,
    )

    spectra, prec, frag = make_synthetic_dia(
        SyntheticConfig(
            n_peptides=n_peptides, n_windows=n_windows, n_cycles=n_cycles,
            noise_peaks_per_spectrum=noise, seed=seed, **kw,
        )
    )
    prec, frag = add_synthetic_decoys(prec, frag)
    return spectra, prec, frag


def make_world(n_peptides, n_cycles, seed=5, **kw):
    from alphadia_torch.rawdata import DiaData

    spectra, prec, frag = make_spectra(n_peptides, n_cycles, seed, **kw)
    return DiaData.from_spectra(spectra, n_scan_bins=N_SCAN_BINS), prec, frag


def select(dia, prec, frag, device, rt_tolerance, batch_size=16384):
    from alphadia_torch.search.selection import CandidateSelection, SelectionConfig

    cfg = SelectionConfig(rt_tolerance=rt_tolerance, candidate_count=3, batch_size=batch_size)
    return CandidateSelection(dia, prec, frag, cfg, device=device)()


def score(dia, prec, frag, cands, device, compute_dtype, batch_size=8192):
    from alphadia_torch.search.scoring import CandidateScoring, ScoringConfig

    cfg = ScoringConfig(batch_size=batch_size, collect_fragments=True, compute_dtype=compute_dtype)
    return CandidateScoring(dia, prec, frag, cfg, device=device)(cands)


def main_path(world, tag="", device=None, rec=None):
    """The three passes of one path, each timed on the host clock after a
    synchronise, with the kernels' launch counts set to 0 just before each
    and read just after; returns (outputs, seconds, launches), keyed by
    pass name + ``tag``; the scan-resolved kernel's counts go to
    ``SCAN_PASS_LAUNCHES`` under the same keys. With ``rec`` the kernels'
    calls are recorded."""
    import torch

    from alphadia_torch.ops import scan_cells_cuda, xic_cuda

    dia, prec, frag = world
    device = device or DEVICE
    out, secs, launches = {}, {}, {}
    steps = (
        ("selection", lambda: select(dia, prec, frag, device, 60.0)),
        ("scoring", lambda: score(dia, prec, frag, out["selection" + tag], device, "bfloat16")),
        ("selection_wide", lambda: select(dia, prec, frag, device, 450.0)),
    )
    for name, fn in steps:
        name += tag
        if rec is not None:
            rec.stage = name
        torch.cuda.synchronize()
        xic_cuda.launches = scan_cells_cuda.launches = 0
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        launches[name] = xic_cuda.launches
        SCAN_PASS_LAUNCHES[name] = scan_cells_cuda.launches
    return out, secs, launches


class Recorder:
    """Wraps the kernels' wrappers where the path calls them, and keeps each
    call's arguments (the device tensors stay referenced): the XIC kernel's
    in ``calls``, the scan-resolved kernel's (``ops/scan_cells_cuda``, the
    4D extractions) in ``scan_calls``. On a clean exit the scan-resolved
    kernel's launches in the block must equal its recorded calls; each call
    runs again and is held to the plain version (``hold_scan_calls``), and
    the launches add to ``SCAN_CELLS_MAIN``."""

    def __init__(self):
        import alphadia_torch.ops.scoring as ops_scoring
        import alphadia_torch.ops.selection as ops_selection
        import alphadia_torch.search.plotting as plotting

        self.modules = (ops_selection, ops_scoring, plotting)
        self.calls = []
        self.original = ops_selection.extract_xic_cuda
        # (module, wrapper name) of each call site of the scan-resolved kernel
        self.scan_sites = (
            (ops_selection, "extract_xic_4d_cuda"),
            (ops_scoring, "extract_xic_4d_cuda"),
            (ops_scoring, "extract_scan_profile_cuda"),
        )
        self.scan_calls = []
        self.scan_launches = 0

    def __enter__(self):
        from alphadia_torch.ops import scan_cells_cuda

        def recording(*args, **kw):
            self.calls.append((self.stage, args, kw))
            return self.original(*args, **kw)

        def scan_recording(fn):
            def wrapped(*args, **kw):
                self.scan_calls.append((self.stage, fn, args, kw))
                before = scan_cells_cuda.launches
                out = fn(*args, **kw)
                self.scan_launches += scan_cells_cuda.launches - before
                return out

            return wrapped

        self.stage = None
        for m in self.modules:
            m.extract_xic_cuda = recording
        self.scan_original = [getattr(m, fn) for m, fn in self.scan_sites]
        for (m, fn), orig in zip(self.scan_sites, self.scan_original):
            setattr(m, fn, scan_recording(orig))
        return self

    def __exit__(self, exc_type, *exc):
        for m in self.modules:
            m.extract_xic_cuda = self.original
        for (m, fn), orig in zip(self.scan_sites, self.scan_original):
            setattr(m, fn, orig)
        if exc_type is None:
            hold_scan_calls(self)


# the scan-resolved kernel's launches on the main paths (every Recorder
# block: [3], [7]-[14], [15b], [16a], [17b]), each held to the plain
# version; the ``scan_cells`` entry's count
SCAN_CELLS_MAIN = {"launches": 0, "held": 0, "max_abs_err": 0.0}
# its launches per pass of ``main_path``, keyed as ``launches``
SCAN_PASS_LAUNCHES = {}
# rows of a recorded call that the plain version takes at a time when held
SCAN_HOLD_ROWS = 256


def hold_scan_calls(rec) -> None:
    """Each recorded call of the scan-resolved kernel run again on its own
    inputs and held to the plain version (``ops/xic.extract_xic_4d`` or
    ``extract_scan_profile``) at the card tests' tolerance; raises unless
    every call launched the kernel once."""
    import torch

    from alphadia_torch.ops import scan_cells_cuda
    from alphadia_torch.ops.xic import extract_scan_profile, extract_xic_4d

    if not rec.scan_calls:
        return
    if rec.scan_launches != len(rec.scan_calls):
        raise AssertionError(
            f"{rec.scan_launches} scan-resolved kernel launches counted, {len(rec.scan_calls)} wrapper calls recorded"
        )
    t0, worst, stages = time.perf_counter(), 0.0, {}
    for stage, fn, args, kw in rec.scan_calls:
        store, cell_start, slot, qmz, tol, *cycles = args
        plain = extract_scan_profile if fn is scan_cells_cuda.extract_scan_profile_cuda else extract_xic_4d
        got = fn(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        # the plain version in pieces of rows, so that its [rows, Q, slab, S]
        # float64 intermediates stay small beside what the path itself held
        for a in range(0, slot.shape[0], SCAN_HOLD_ROWS):
            b = a + SCAN_HOLD_ROWS
            want = plain(store.packed[:, 0], store.packed[:, 1], store.scanbin, cell_start, slot[a:b], qmz[a:b], tol,
                         *(c[a:b] for c in cycles), **kw)
            for g, w, atol in zip(got, want if isinstance(want, tuple) else (want,), (0.0, 1e-9)):
                torch.testing.assert_close(g[a:b], w, rtol=1e-6, atol=atol,
                                           msg=lambda m: f"scan-resolved kernel, {stage}, rows {a}-{b}: {m}")
                worst = max(worst, float((g[a:b] - w).abs().max()) if w.numel() else 0.0)
            del want
        stages[stage] = stages.get(stage, 0) + 1
        del got
    torch.cuda.synchronize()
    SCAN_CELLS_MAIN["launches"] += rec.scan_launches
    SCAN_CELLS_MAIN["held"] += len(rec.scan_calls)
    SCAN_CELLS_MAIN["max_abs_err"] = max(SCAN_CELLS_MAIN["max_abs_err"], worst)
    log(
        f"[scan_cells] {rec.scan_launches} launches of the scan-resolved kernel recorded per stage {json.dumps(stages)}, "
        f"each held to the plain version (max abs err {worst:.3g}) in {time.perf_counter() - t0:.2f} s; on the main "
        f"paths so far {SCAN_CELLS_MAIN['launches']}"
    )


def variant(kw) -> str:
    if kw.get("scan_lo") is not None:
        return "c_scan_window"
    if kw.get("cycle_stride", 1) > 1:
        return "d_coarse"
    return "b_mz_delta" if kw.get("with_mz") else "a_intensity"


def truth_share(dia, prec, cands) -> float:
    """Share of detectable targets whose best candidate's frame_center lies
    within 3 cycles of the true apex (the generator's ``_truth_rt``)."""
    det = prec["_truth_detectable"] & (prec["decoy"] == 0)
    truth_cycle = np.abs(dia.cycle_rt[None, :] - prec["_truth_rt"][:, None]).argmin(1)
    best = cands["rank"] == 0
    where = {int(p): int(c) for p, c in zip(cands["precursor_idx"][best], cands["frame_center"][best])}
    idx = prec["precursor_idx"][det]
    hit = [abs(where.get(int(p), -10**6) - int(c)) <= 3 for p, c in zip(idx, truth_cycle[det])]
    return float(np.mean(hit)) if hit else 0.0


def scan_share(dia, prec, cands) -> float:
    """Share of detectable targets whose best candidate's scan_center lies
    within 1 bin of the store's bin of the true mobility."""
    det = prec["_truth_detectable"] & (prec["decoy"] == 0)
    span = max(dia.mobility_max - dia.mobility_min, 1e-9)
    truth_bin = np.clip(
        ((prec["_truth_mobility"] - dia.mobility_min) / span * dia.n_scan_bins).astype(np.int64),
        0, dia.n_scan_bins - 1,
    )
    best = cands["rank"] == 0
    where = {int(p): int(c) for p, c in zip(cands["precursor_idx"][best], cands["scan_center"][best])}
    hit = [abs(where.get(int(p), -10**6) - int(c)) <= 1 for p, c in zip(prec["precursor_idx"][det], truth_bin[det])]
    return float(np.mean(hit)) if hit else 0.0


# ---------------------------------------------------------------------------
# kernel vs plain
# ---------------------------------------------------------------------------
def compare(args, kw):
    """Max abs and rel error and the count of elements outside the
    tolerance, per output plane, of the kernel against the plain version."""
    import torch

    from alphadia_torch.ops.xic import extract_xic_packed
    from alphadia_torch.ops.xic_cuda import extract_xic_cuda

    k = extract_xic_cuda(*args, **kw)
    torch.cuda.synchronize()
    p = extract_xic_packed(*args, **kw)
    torch.cuda.synchronize()
    return plane_errors(k, p, kw)


def plane_errors(k, p, kw):
    """Per output plane of a kernel result ``k`` against the plain version's
    ``p``: max abs and rel error, the count outside the tolerance, and
    sum |plain|."""
    k = k if isinstance(k, tuple) else (k,)
    p = p if isinstance(p, tuple) else (p,)
    tols = (TOL_INTENSITY, TOL_MZ_DELTA if kw.get("mz_as_delta") else TOL_MZ_ABSOLUTE)
    res = []
    for a, b, (rtol, atol) in zip(k, p, tols):
        err = (a - b).abs()
        bad = int((err > atol + rtol * b.abs()).sum())
        rel = float((err / b.abs().clamp(min=1e-6)).max())
        res.append((float(err.max()), rel, bad, float(b.abs().sum())))
    return res


def small_world_agreement(with_mobility):
    """One path on the card against the same path on the CPU (plain
    version) on a small world: candidates of the 60 s and the wide 450 s
    selection, and the PSM features of float32 and of bfloat16 scoring.
    Returns per selection the candidate match and count, and per compute
    dtype the paired PSMs and their feature deviations relative to
    max(|value|, 1) (mass errors: absolute, ppm)."""
    from alphadia_torch.search.scoring import FEATURE_COLUMNS

    dia, prec, frag = make_world(300, 300, seed=11, with_mobility=with_mobility)
    out = {}
    for device in (DEVICE, "cpu"):
        dia.free_device()
        cands = {rt: select(dia, prec, frag, device, rt, batch_size=1024) for rt in (60.0, 450.0)}
        psms = {dt: score(dia, prec, frag, cands[60.0], device, dt, batch_size=1024)[0] for dt in ("float32", "bfloat16")}
        out[device] = (cands, psms)
    dia.free_device()
    (cg, pg), (cc, pc) = out[DEVICE], out["cpu"]
    cols = ("precursor_idx", "rank", "frame_start", "frame_center", "frame_stop")
    cols += ("scan_start", "scan_center", "scan_stop") if with_mobility else ()

    def keys(c):
        return set(zip(*(c[k].tolist() for k in cols)))

    match = {}
    for rt in cg:
        kg, kc = keys(cg[rt]), keys(cc[rt])
        match[rt] = len(kg & kc) / max(len(kg | kc), 1), len(kc)
    devs = {}
    for dt in pg:
        g, c = pg[dt], pc[dt]
        ig = {k: i for i, k in enumerate(zip(g["precursor_idx"].tolist(), g["rank"].tolist()))}
        pairs = [(ig[k], i) for i, k in enumerate(zip(c["precursor_idx"].tolist(), c["rank"].tolist())) if k in ig]
        gi, ci = [p[0] for p in pairs], [p[1] for p in pairs]
        devs[dt] = len(pairs), len(c["precursor_idx"]), {
            f: np.abs(g[f][gi].astype(np.float64) - c[f][ci]) / (1.0 if f in MASS_ERRORS else np.maximum(np.abs(c[f][ci]), 1.0))
            for f in FEATURE_COLUMNS
        }
    return match, devs


def check_agreement(label, with_mobility):
    match, devs = small_world_agreement(with_mobility)
    for rt, (cand_match, n_c) in match.items():
        log(
            f"[3] {label} small world, rt {rt:.0f} s selection, card vs CPU: {cand_match:.4f} of {n_c} candidates "
            f"identical (bound {CANDIDATE_MATCH_MIN})"
        )
        if cand_match < CANDIDATE_MATCH_MIN:
            raise AssertionError(f"{label}: candidates on the card disagree with the plain path on the CPU")
    n_p, n_cpu, d = devs["float32"]
    feat_ok = float(np.mean(np.concatenate([v <= FEATURE_REL_TOL for v in d.values()])))
    log(
        f"[3] {label} small world, float32 scoring: {n_p} of {n_cpu} PSMs paired, {feat_ok:.4f} of feature "
        f"values within {FEATURE_REL_TOL} (bound 0.99)"
    )
    if n_p < 0.99 * n_cpu or feat_ok < 0.99:
        raise AssertionError(f"{label}: float32 scoring on the card disagrees with the plain path on the CPU")
    n_p, n_cpu, d = devs["bfloat16"]
    med = {f: float(np.median(v)) for f, v in d.items()}
    q90 = {f: float(np.quantile(v, 0.9)) for f, v in d.items()}
    worst_f = max(med, key=lambda f: med[f] / BF16_TOL.get(f, BF16_TOL_DEFAULT))
    worst_q = max(q90, key=q90.get)
    worst_m = max(d, key=lambda f: d[f].max())
    log(
        f"[3] {label} small world, bfloat16 scoring: {n_p} of {n_cpu} PSMs paired; largest median deviation against "
        f"its tolerance: {worst_f} {med[worst_f]:.3g} (tol {BF16_TOL.get(worst_f, BF16_TOL_DEFAULT)}); largest 90th "
        f"percentile: {worst_q} {q90[worst_q]:.3g} (tol {FEATURE_REL_TOL}); largest: {worst_m} {d[worst_m].max():.3g}"
    )
    bad = [f for f in d if med[f] > BF16_TOL.get(f, BF16_TOL_DEFAULT) or q90[f] > FEATURE_REL_TOL]
    if n_p < 0.99 * n_cpu or bad:
        raise AssertionError(f"{label}: bfloat16 scoring on the card disagrees with the plain path on the CPU: {bad}")


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def device_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` over ``reps`` back-to-back runs. A sleep
    kernel keeps the card busy while the host enqueues them, so host
    overhead between launches does not count."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_flushed(fn, reps, flush):
    """Median device time of ``fn`` over ``reps`` runs, each timed alone
    after a write of ``flush`` (64 MiB, more than the 50 MB L2) has evicted
    what earlier runs left in the cache: the cost a launch pays on the main
    path, where other kernels run between two XIC launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(50_000_000)  # the card waits while the host enqueues every run
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def slabs(args, kw):
    """Per query of one launch: its row of ``cell_start`` (flat offsets of
    its window's first and last edge, ``lo`` and ``hi``), its slab's first
    peak ``r0`` and its length, clipped to ``slab`` (0 for a masked query or
    an empty window)."""
    import torch

    from alphadia_torch.ops.xic import query_rows

    _, cell_start, slot, qmz, _, c0 = args
    W, n_cycles, L = kw["window_len"], kw["n_cycles"], cell_start.shape[2]
    row = query_rows(
        slot, qmz, n_slots=cell_start.shape[0], n_bins=kw["n_bins"],
        bin_mz_min=kw["bin_mz_min"], bin_width=kw["bin_width"],
    )
    lo = row * L + c0.long().clamp(0, n_cycles)[:, None]
    hi = row * L + (c0.long() + W).clamp(0, n_cycles)[:, None]
    flat = cell_start.reshape(-1)
    r0 = flat[lo].long()
    length = torch.where(slot >= 0, (flat[hi].long() - r0).clamp(0, kw["slab"]), 0)
    return lo, hi, r0, length


def store_layout(store):
    """(rows, bytes of a row's m/z and intensity, bytes of its scan bin) of
    the store a launch was given: a ``PeakStore``, or the f32[N, 4] rows
    (m/z, intensity, cycle, scan bin) of older commits, so that this script
    also times their kernel."""
    if isinstance(store, tuple):
        return store.packed.shape[0], store.packed[0].nbytes, store.scanbin.element_size()
    return store.shape[0], 2 * store.element_size(), store.element_size()


def work(args, kw):
    """(bytes, operations) that one launch must move and do on these
    inputs. Bytes: each input read once (the peaks that some query's slab
    covers; the cell offsets that some query reads, 4 or 8 B each as the
    index is int32 or int64; the query arrays) and
    each output plane written once. Queries of one slot and m/z bin share
    their peaks, which are counted once. A peak costs its m/z and intensity
    (8 B), and its scan bin (2 B more in the store's i16 plane) under a
    scan window: the cells come from ``cell_start``, so its cycle is not
    part of the function's input. Operations: about eight float operations
    for each (query, slab peak) pair."""
    import torch

    store, cell_start, slot, _, _, _ = args
    B, Q = slot.shape
    n_rows, peak_bytes, scan_bytes = store_layout(store)
    lo, hi, r0, slab = slabs(args, kw)
    # peaks covered by at least one slab: +1 at each start, -1 at each end
    edge = torch.zeros(n_rows + 1, dtype=torch.int32, device=slot.device)
    live = slab > 0
    edge.index_add_(0, r0[live], torch.ones_like(r0[live], dtype=torch.int32))
    edge.index_add_(0, (r0 + slab)[live], -torch.ones_like(r0[live], dtype=torch.int32))
    unique_peaks = int((torch.cumsum(edge, 0)[:-1] > 0).sum())
    offsets = int(torch.unique(torch.cat([lo[slot >= 0], hi[slot >= 0]])).numel())
    planes = 2 if kw.get("with_mz") else 1
    nbytes = (
        unique_peaks * peak_bytes + offsets * cell_start.element_size() + B * Q * 8 + B * 4
        + planes * B * Q * kw["window_len"] * 4
    )
    if kw.get("scan_lo") is not None:
        nbytes += unique_peaks * scan_bytes + 2 * B * 4
    return nbytes, 8 * int(slab.sum())


def covered_bytes(args, kw) -> int:
    """The bytes that this launch's loads, copies and stores cover in the
    kernel of ``csrc/xic.cu``, repeats included: each query's slot and m/z,
    its row's window start (and scan window); a valid query's two window
    edges; a live query's slab, cut into pieces of ``KERNEL_PIECE`` peaks,
    each copied as the 8-peak aligned span that covers it, at 10 B a peak
    (m/z and intensity, the cycle) or 12 B under a scan window (the scan
    bin); every output plane once."""
    _, _, slot, _, _, _ = args
    B, Q = slot.shape
    _, _, r0, slab = slabs(args, kw)
    scan = kw.get("scan_lo") is not None
    span_peaks = 0
    for k in range(-(-kw["slab"] // KERNEL_PIECE)):
        count = (slab - k * KERNEL_PIECE).clamp(0, KERNEL_PIECE)
        start = r0 + k * KERNEL_PIECE
        span = (((start + count + 7) // 8) * 8 - (start // 8) * 8)[count > 0]
        span_peaks += int(span.sum())
    planes = 2 if kw.get("with_mz") else 1
    return (
        B * Q * 8 + B * 4 + (2 * B * 4 if scan else 0) + int((slot >= 0).sum()) * 8
        + span_peaks * (12 if scan else 10) + planes * B * Q * kw["window_len"] * 4
    )


def plain_peak_bytes(args, kw) -> int:
    """Device memory the plain version allocates beyond its inputs."""
    import torch

    from alphadia_torch.ops.xic import extract_xic_packed

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    extract_xic_packed(*args, **kw)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


class Annotate:
    """Wraps the 4D path's extractions (the scan-resolved kernel's wrappers)
    in ``record_function`` ranges (for one traced pass only), so the trace
    can sum their device time."""

    NAMES = ("extract_xic_4d_cuda", "extract_scan_profile_cuda")

    def __enter__(self):
        import alphadia_torch.ops.scoring as ops_scoring
        import alphadia_torch.ops.selection as ops_selection
        from torch.profiler import record_function

        self.saved = []
        for m in (ops_selection, ops_scoring):
            for name in self.NAMES:
                if hasattr(m, name):
                    fn = getattr(m, name)

                    def wrapped(*a, _fn=fn, _name=name, **kw):
                        with record_function(_name):
                            return _fn(*a, **kw)

                    self.saved.append((m, name, fn))
                    setattr(m, name, wrapped)
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def profile_main_path(world, tag, out_dir: Path):
    """Trace one more pass of a path with torch.profiler: device busy share,
    the XIC kernel's device time, the device time under the 4D
    extractions, and the ops that take the device time (table written to
    ``out_dir/profile_main_path{tag}.txt``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    def self_dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    torch.cuda.synchronize()
    with Annotate(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        _, secs, _ = main_path(world, tag)
        wall = time.perf_counter() - t0
    rows = prof.key_averages()
    # device-side events only: an aten op's own row repeats its kernels' time
    events = sorted(
        (e for e in rows if str(getattr(e, "device_type", "")).endswith("CUDA") and e.key not in Annotate.NAMES),
        key=self_dev_us, reverse=True,
    )
    busy = sum(self_dev_us(e) for e in events) * 1e-6
    xic = sum(self_dev_us(e) for e in events if "xic_kernel" in e.key) * 1e-6
    # the kernels launched under each annotated range, from its host-side row
    under = {
        n: sum(dev_us(e) for e in rows if e.key == n and not str(getattr(e, "device_type", "")).endswith("CUDA")) * 1e-6
        for n in Annotate.NAMES
    }
    counts = {n: sum(e.count for e in rows if e.key == n and not str(getattr(e, "device_type", "")).endswith("CUDA")) for n in Annotate.NAMES}
    lines = [f"{self_dev_us(e) / 1e3:10.3f} ms {e.count:7d}x  {e.key[:110]}" for e in events[:40]]
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"profile_main_path{tag}.txt").write_text("\n".join(lines) + "\n")
    log(
        f"[profile{tag}] traced pass: wall {wall:.4f} s (passes {json.dumps({k: round(v, 4) for k, v in secs.items()})}), "
        f"device busy {busy:.4f} s = {busy / wall:.3f} of wall, XIC kernel {xic * 1e3:.3f} ms"
    )
    if any(counts.values()):
        log(
            f"[profile{tag}] device time under " + ", ".join(
                f"{n} {under[n] * 1e3:.3f} ms ({counts[n]} calls, {under[n] / max(busy, 1e-12):.3f} of busy)" for n in Annotate.NAMES
            )
        )
    for line in lines[:15]:
        log(f"[profile{tag}] {line}")


def record_and_compare(worlds, spectra):
    """A warm-up of each path with every kernel call recorded (the three
    passes, the pipelined driver of phase [6] and, on the 4D world, its
    RT-windowed search); then each call's kernel result against the plain
    version. Returns the calls and, per variant, the largest abs and rel
    errors."""
    import torch

    t0 = time.perf_counter()
    with Recorder() as rec:
        warm = {tag: main_path(world, tag, rec=rec)[0] for tag, world in worlds.items()}
        for tag, world in worlds.items():
            rec.stage = "pipelined" + tag
            pipelined(world)
        rec.stage = "rt_windowed_4d"
        rt_windowed(spectra["_4d"], worlds["_4d"])
    torch.cuda.synchronize()
    log(f"[3] warm-up passes of both paths: {len(rec.calls)} kernel launches recorded in {time.perf_counter() - t0:.2f} s")
    worst = {}
    for stage, args, kw in rec.calls:
        res = compare(args, kw)
        v = variant(kw)
        B, Q = args[2].shape
        for plane, (mabs, mrel, bad, total) in zip(("intensity", "mz"), res):
            log(
                f"[3] {stage:17s} {v:13s} B={B} Q={Q} W={kw['window_len']} stride={kw.get('cycle_stride', 1)} "
                f"{plane:9s} max_abs={mabs:.3g} max_rel={mrel:.3g} outside_tol={bad} sum|plain|={total:.6g}"
            )
            if bad:
                raise AssertionError(f"kernel disagrees with the plain version: {stage} {v} {plane}")
            w = worst.setdefault(v, [0.0, 0.0])
            w[0], w[1] = max(w[0], mabs), max(w[1], mrel)
    # the 4D scoring pass launches the kernel with a scan window, twice
    # (fragments, precursors) on every batch
    from alphadia_torch.utils.device import batch_schedule

    c4 = [kw for stage, _, kw in rec.calls if stage == "scoring_4d"]
    batches = len(batch_schedule(len(warm["_4d"]["selection_4d"]["precursor_idx"]), SCAN_BATCH))
    log(f"[3] 4D scoring: {len(c4)} launches for {batches} batches, {sum(k.get('scan_lo') is not None for k in c4)} with a scan window")
    if len(c4) != 2 * batches or any(k.get("scan_lo") is None for k in c4):
        raise AssertionError("the 4D scoring pass does not launch the scan-window kernel on every batch")
    return rec.calls, worst


def path_checks(label, tag, world, out, launches, kernel_passes):
    """The truth and PSM shares of one path's counted run, its outputs'
    shape, and that the passes that run the kernel launched it."""
    from alphadia_torch.search.scoring import FEATURE_COLUMNS

    dia, prec, frag = world
    cands, (psm, frags), wide = out["selection" + tag], out["scoring" + tag], out["selection_wide" + tag]
    feats = np.stack([psm[f] for f in FEATURE_COLUMNS], 1)
    share = truth_share(dia, prec, cands)
    share_wide = truth_share(dia, prec, wide)
    wide_min = TRUTH_SHARE_WIDE_4D_MIN if tag else TRUTH_SHARE_MIN
    log(
        f"[4] {label}: candidates {len(cands['precursor_idx'])}, PSMs {len(psm['precursor_idx'])}, fragments "
        f"{len(frags['mz'])}, wide-window candidates {len(wide['precursor_idx'])}"
    )
    log(f"[4] {label}: kernel launches per pass: {json.dumps(launches)}")
    scan = {p + tag: SCAN_PASS_LAUNCHES[p + tag] for p in ("selection", "scoring", "selection_wide")}
    log(f"[4] {label}: scan-resolved kernel launches per pass: {json.dumps(scan)}")
    if (min(scan.values()) <= 0) if tag else any(scan.values()):
        raise AssertionError(f"{label}: the 4D passes and only they launch the scan-resolved kernel: {scan}")
    log(
        f"[4] {label}: truth share (best candidate within 3 cycles of the apex): {share:.4f} (bound {TRUTH_SHARE_MIN}); "
        f"wide window {share_wide:.4f} (bound {wide_min})"
    )
    if tag:
        log(
            f"[4] {label}: scan share (best candidate's scan_center within 1 bin of the true mobility's bin, not "
            f"gated): {scan_share(dia, prec, cands):.4f}; wide window {scan_share(dia, prec, wide):.4f}"
        )
        for f in ("fragment_scan_correlation", "template_scan_correlation", "mobility_fwhm", "mobility_observed", "base_width_mobility"):
            log(f"[4] {label}: {f} non-zero in {float((psm[f] != 0).mean()):.4f} of PSMs, median {float(np.median(psm[f])):.4g}")
    if min(launches[p + tag] for p in kernel_passes) <= 0:
        raise AssertionError(f"{label}: a pass that runs the kernel launched it no time: {launches}")
    if feats.shape != (len(psm["precursor_idx"]), len(FEATURE_COLUMNS)) or not np.isfinite(feats).all():
        raise AssertionError(f"{label}: PSM features are not finite values of the expected shape")
    targets = prec["precursor_idx"][prec["_truth_detectable"] & (prec["decoy"] == 0)]
    psm_share = float(np.isin(targets, psm["precursor_idx"]).mean())
    log(f"[4] {label}: detectable targets with a PSM: {psm_share:.4f} (bound {PSM_SHARE_MIN})")
    if psm_share < PSM_SHARE_MIN:
        raise AssertionError(f"{label}: too few detectable targets were scored")
    if share < TRUTH_SHARE_MIN or share_wide < wide_min:
        raise AssertionError(f"{label}: candidates miss the true apexes")


def timed_passes(label, world, tag, repeats, name, card):
    n_prec = len(world[1]["precursor_idx"])
    walls = [main_path(world, tag)[1] for _ in range(repeats)]
    rates = sorted(n_prec / (w["selection" + tag] + w["scoring" + tag]) for w in walls)
    for stage in walls[0]:
        ms = sorted(w[stage] * 1e3 for w in walls)
        log(f"[4] {label}: {repeats} more passes, {stage} wall ms: median {np.median(ms):.2f}, min {ms[0]:.2f}, max {ms[-1]:.2f}")
    log(
        f"[4] {label}: {repeats} more passes, precursors/s (selection+scoring): median {np.median(rates):.1f}, "
        f"min {rates[0]:.1f}, max {rates[-1]:.1f} ({name}, {card})"
    )


# ---------------------------------------------------------------------------
# 6. IDs at 1% FDR
# ---------------------------------------------------------------------------
def fdr_configs():
    """Selection and scoring configs of phase [6]: the main path's
    selection, float32 scoring (the classifier's training precision)."""
    from alphadia_torch.search.scoring import ScoringConfig
    from alphadia_torch.search.selection import SelectionConfig

    return SelectionConfig(rt_tolerance=60.0, candidate_count=3), ScoringConfig(batch_size=8192, collect_fragments=True)


def sequential(world, device=None):
    from alphadia_torch.search.scoring import CandidateScoring
    from alphadia_torch.search.selection import CandidateSelection

    dia, prec, frag = world
    device = device or DEVICE
    sel_cfg, score_cfg = fdr_configs()
    cands = CandidateSelection(dia, prec, frag, sel_cfg, device=device)()
    return (cands, *CandidateScoring(dia, prec, frag, score_cfg, device=device)(cands))


def pipelined(world, device=None):
    from alphadia_torch.search.pipelined import PipelinedExtraction

    dia, prec, frag = world
    return PipelinedExtraction(dia, prec, frag, *fdr_configs(), device=device or DEVICE)()


def rt_windowed(spectra, world, device=None):
    from alphadia_torch.search.streaming import RtWindowedSearch

    _, prec, frag = world
    search = RtWindowedSearch(
        spectra, prec, frag, *fdr_configs(), n_rt_windows=RT_WINDOWS,
        diadata_kwargs={"n_scan_bins": N_SCAN_BINS}, device=device or DEVICE,
    )
    return search, search()


def counted(fn):
    """``fn()`` on the card with the kernel's count set to 0 just before and
    read just after: (result, wall seconds, launches)."""
    import torch

    from alphadia_torch.ops import xic_cuda

    torch.cuda.synchronize()
    xic_cuda.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, xic_cuda.launches


def paired_features(a, b):
    """PSMs of ``a`` and ``b`` paired by (precursor_idx, rank): the key sets,
    and per feature the deviation of a from b relative to max(|b|, 1) (mass
    errors: absolute, ppm) and whether the values are bit-equal."""
    from alphadia_torch.search.scoring import FEATURE_COLUMNS

    ka = list(zip(a["precursor_idx"].tolist(), a["rank"].tolist()))
    kb = list(zip(b["precursor_idx"].tolist(), b["rank"].tolist()))
    ib = {k: i for i, k in enumerate(kb)}
    pairs = [(i, ib[k]) for i, k in enumerate(ka) if k in ib]
    ia, jb = np.array([p[0] for p in pairs], np.int64), np.array([p[1] for p in pairs], np.int64)
    dev = np.concatenate([
        np.abs(a[f][ia].astype(np.float64) - b[f][jb]) / (1.0 if f in MASS_ERRORS else np.maximum(np.abs(b[f][jb]), 1.0))
        for f in FEATURE_COLUMNS
    ])
    equal = np.concatenate([a[f][ia] == b[f][jb] for f in FEATURE_COLUMNS])
    return set(ka), set(kb), dev, equal, ia, jb


def check_same_psms(label, what, a, b, card):
    """Keys identical, features >= FEATURE_MATCH_MIN within FEATURE_REL_TOL."""
    ka, kb, dev, equal, _, _ = paired_features(a, b)
    within = float(np.mean(dev <= FEATURE_REL_TOL)) if len(dev) else 0.0
    log(
        f"[6] {label} {what}: PSM keys {len(ka)} / {len(kb)}, identical {ka == kb}; feature values within "
        f"{FEATURE_REL_TOL} {within:.6f} (bound {FEATURE_MATCH_MIN}), bit-equal {float(np.mean(equal)):.6f} ({card})"
    )
    if ka != kb or within < FEATURE_MATCH_MIN:
        raise AssertionError(f"{label}: {what} disagree")


def id_shares(dia, prec, out):
    """(identified share, realised false share, targets, decoys) at q <=
    0.01: the share of detectable targets with an accepted target PSM, and
    the share of accepted targets whose PSM lies more than 3 cycles from the
    generator's true apex."""
    accepted = out["qval"] <= 0.01
    target = out["_decoy"] == 0
    pidx = out["precursor_idx"][accepted & target]
    det = prec["_truth_detectable"] & (prec["decoy"] == 0)
    identified = float(np.isin(prec["precursor_idx"][det], pidx).mean())
    truth_cycle = np.abs(dia.cycle_rt[None, :] - prec["_truth_rt"][:, None]).argmin(1)
    row = {int(p): i for i, p in enumerate(prec["precursor_idx"])}
    rows = np.array([row[int(p)] for p in pidx], np.int64)
    off = np.abs(out["frame_center"][accepted & target] - truth_cycle[rows]) > 3
    return identified, float(off.mean()) if len(off) else 0.0, len(pidx), int((accepted & ~target).sum())


class MethodTimes:
    """Host seconds spent in the given methods, summed per key."""

    def __init__(self, entries):
        self.entries = entries

    def __enter__(self):
        self.seconds = {}
        self.saved = []
        for obj, attr, key in self.entries:
            fn = getattr(obj, attr)
            self.saved.append((obj, attr, fn))

            def timed(*a, _fn=fn, _key=key, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.seconds[_key] = self.seconds.get(_key, 0.0) + time.perf_counter() - t0

            setattr(obj, attr, timed)
        return self

    def __exit__(self, *exc):
        for obj, attr, fn in self.saved:
            setattr(obj, attr, fn)


def fdr_step_times() -> MethodTimes:
    """Host seconds of the FDR steps, each wrapped where ``perform_fdr``
    calls it: the fit (ends when its losses reach the host), the
    probabilities, the q-values, fragment competition and ``keep_best``."""
    import alphadia_torch.fdr.fdr as fdr_mod
    from alphadia_torch.models.classifier import BinaryClassifier

    return MethodTimes([
        (BinaryClassifier, "fit", "fit"), (BinaryClassifier, "predict_proba", "predict"),
        (fdr_mod, "get_q_values", "q_values"), (fdr_mod.FragmentCompetition, "__call__", "fragment_competition"),
        (fdr_mod, "keep_best", "keep_best"),
    ])


def fdr_manager(dia, device=None):
    from alphadia_torch.models.classifier import BinaryClassifier
    from alphadia_torch.workflow.managers.fdr_manager import FDRManager
    from alphadia_torch.workflow.peptidecentric.peptidecentric import FDR_FEATURE_COLUMNS

    return FDRManager(
        FDR_FEATURE_COLUMNS, BinaryClassifier(random_state=0, device=device or DEVICE), dia_cycle=dia.cycle,
        random_state=0,
    )


def ids_at_1pct(label, tag, world, psm, frags, name, card):
    """``FDRManager.fit_predict`` on the pipelined PSMs, its steps timed;
    the estimator, the IDs at 1% FDR and their truth, gated."""
    dia, prec, _ = world
    mgr = fdr_manager(dia)
    with fdr_step_times() as st:
        t0 = time.perf_counter()
        out = mgr.fit_predict(psm, decoy_strategy="precursor", competitive=True, df_fragments=frags)
        wall = time.perf_counter() - t0
    est = out.attrs["fdr_estimator"]
    steps = mgr.classifier_store[-1].n_steps if mgr.classifier_store else 0
    identified, false, n_t, n_d = id_shares(dia, prec, out)
    s = st.seconds
    log(
        f"[6] {label} FDR: estimator {est}, {len(psm['precursor_idx'])} PSMs; fit_predict {wall:.4f} s: fit "
        f"{s.get('fit', 0.0):.4f} s, {steps} steps, {s.get('fit', 0.0) / max(steps, 1) * 1e3:.4f} ms a step; predict "
        f"{s.get('predict', 0.0) * 1e3:.2f} ms; host: q-values {s.get('q_values', 0.0):.4f} s, fragment competition "
        f"{s.get('fragment_competition', 0.0):.4f} s, keep_best {s.get('keep_best', 0.0):.4f} s ({name}, {card})"
    )
    log(
        f"[6] {label} IDs at 1% FDR: {n_t} targets, {n_d} decoys; identified share of detectable targets "
        f"{identified:.4f} (bound {IDENTIFIED_MIN[tag]}); realised false share {false:.4f} (bound {FALSE_MAX[tag]}) "
        f"({name}, {card})"
    )
    if est != "nn":
        raise AssertionError(f"{label}: the FDR estimator is {est}, not the network")
    if identified < IDENTIFIED_MIN[tag] or false > FALSE_MAX[tag]:
        raise AssertionError(f"{label}: IDs at 1% FDR miss their gates")


class FrozenClassifier:
    """A fitted classifier that ``fit`` leaves as it is."""

    fitted = True

    def __init__(self, clf):
        self.clf = clf

    def fit(self, x, y):
        pass

    def predict_proba(self, x):
        return self.clf.predict_proba(x)


def classifier_card_vs_cpu(name, card):
    """On a small world (the CPU path's PSMs): the packaged classifier's
    state on both devices (probabilities within CLASSIFIER_PROBA_TOL, the
    same IDs at 1%), and two independent fits, card and CPU (Jaccard of
    their IDs at 1% >= FIT_JACCARD_MIN). The card's fit is the first of the
    process: its wall holds the start-up of the training kernels."""
    from alphadia_torch.fdr.fdr import perform_fdr
    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.utils.frame import take

    spectra, prec, frag = make_spectra(300, 400, n_windows=1, noise=200)
    dia = DiaData.from_spectra(spectra)
    _, psm, frags = pipelined((dia, prec, frag), device="cpu")
    managers = {d: fdr_manager(dia, d) for d in (DEVICE, "cpu")}
    clfs = {d: m._load_packaged_classifier() for d, m in managers.items()}
    cols = [c for c in managers["cpu"].feature_columns if c in psm]
    X = np.stack([psm[c].astype(np.float32) for c in cols], 1)
    diff = float(np.abs(clfs[DEVICE].predict_proba(X) - clfs["cpu"].predict_proba(X)).max())

    def ids(out):
        return set(out["precursor_idx"][(out["qval"] <= 0.01) & (out["_decoy"] == 0)].tolist())

    target, decoy = take(psm, psm["decoy"] == 0), take(psm, psm["decoy"] == 1)
    frozen = {
        d: ids(perform_fdr(FrozenClassifier(c), cols, target, decoy, competitive=True, random_state=0)) for d, c in clfs.items()
    }
    fits, walls = {}, {}
    for d, m in managers.items():
        t0 = time.perf_counter()
        fits[d] = m.fit_predict(psm, competitive=True, df_fragments=frags)
        walls[d] = time.perf_counter() - t0
    fit_ids = {d: ids(out) for d, out in fits.items()}
    jac = len(fit_ids[DEVICE] & fit_ids["cpu"]) / max(len(fit_ids[DEVICE] | fit_ids["cpu"]), 1)
    log(
        f"[6] classifier, card vs CPU on a small world ({len(psm['precursor_idx'])} PSMs): one state, max proba "
        f"difference {diff:.3g} (bound {CLASSIFIER_PROBA_TOL}), IDs at 1% {len(frozen[DEVICE])} / {len(frozen['cpu'])} "
        f"identical {frozen[DEVICE] == frozen['cpu']}; two fits ({fits[DEVICE].attrs['fdr_estimator']}, "
        f"{fits['cpu'].attrs['fdr_estimator']}): IDs {len(fit_ids[DEVICE])} / {len(fit_ids['cpu'])}, Jaccard {jac:.4f} "
        f"(bound {FIT_JACCARD_MIN}); fit_predict walls: card {walls[DEVICE]:.4f} s (the process's first fit on the card), "
        f"CPU {walls['cpu']:.4f} s ({name}, {card})"
    )
    if diff > CLASSIFIER_PROBA_TOL or frozen[DEVICE] != frozen["cpu"] or jac < FIT_JACCARD_MIN:
        raise AssertionError("the classifier on the card disagrees with the CPU")
    if any(f.attrs["fdr_estimator"] != "nn" for f in fits.values()):
        raise AssertionError("the small world's fits did not take the network")


def candidate_keys(c):
    cols = ("precursor_idx", "rank", "frame_start", "frame_center", "frame_stop", "scan_start", "scan_center", "scan_stop")
    return set(zip(*(c[k].tolist() for k in cols)))


def phase6(label, tag, world, name, card, launches, secs, spectra=None):
    """Pipelined against sequential (wall, launches, equality), the FDR
    stack on the pipelined PSMs, and (4D) the RT-windowed search against
    the whole-run pipelined one."""
    import torch

    n_prec = len(world[1]["precursor_idx"])
    runs = {"sequential": [], "pipelined": []}
    outs = {}
    for kind in ("sequential", "pipelined", "pipelined", "sequential", "sequential", "pipelined"):
        out, wall, n = counted(lambda: (sequential if kind == "sequential" else pipelined)(world))
        runs[kind].append((wall, n))
        outs.setdefault(kind, out)
    for kind, r in runs.items():
        walls = sorted(w for w, _ in r)
        log(
            f"[6] {label} {kind}: wall s {', '.join(f'{w:.4f}' for w, _ in r)}; median {np.median(walls):.4f} s = "
            f"{n_prec / np.median(walls):.1f} precursors/s; kernel launches {r[0][1]} ({name}, {card})"
        )
        if r[0][1] <= 0:
            raise AssertionError(f"{label}: the {kind} path launched the kernel no time")
    launches["pipelined" + tag] = runs["pipelined"][0][1]
    secs["pipelined" + tag] = runs["pipelined"][0][0]
    (cs, ps, _), (cp, pp, fp) = outs["sequential"], outs["pipelined"]
    same = candidate_keys(cs) == candidate_keys(cp)
    log(
        f"[6] {label} candidates: sequential {len(cs['precursor_idx'])}, pipelined {len(cp['precursor_idx'])}, "
        f"identical sets {same} ({card})"
    )
    if not same:
        raise AssertionError(f"{label}: pipelined candidates differ from the sequential ones")
    check_same_psms(label, "pipelined vs sequential PSMs", pp, ps, card)
    ids_at_1pct(label, tag, world, pp, fp if not tag else None, name, card)
    if spectra is None:
        return
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, wall_whole, _ = counted(lambda: pipelined(world))
    whole_mem = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (search, (pw, _)), wall_win, n = counted(lambda: rt_windowed(spectra, world))
    win_mem = torch.cuda.max_memory_allocated()
    launches["rt_windowed" + tag] = n
    secs["rt_windowed" + tag] = wall_win
    log(
        f"[6] {label} RT-windowed search ({RT_WINDOWS} windows): wall {wall_win:.4f} s, {n} kernel launches, "
        f"max_memory_allocated {win_mem / 2**30:.3f} GiB against {whole_mem / 2**30:.3f} GiB for the whole run "
        f"({wall_whole:.4f} s; {base / 2**30:.3f} GiB resident before either), peak window store "
        f"{search.peak_window_slab_mb:.1f} MB ({name}, {card})"
    )
    if n <= 0:
        raise AssertionError(f"{label}: the RT-windowed search launched the kernel no time")
    ia = {k: i for i, k in enumerate(zip(pw["precursor_idx"].tolist(), pw["rank"].tolist()))}
    keys = list(zip(pp["precursor_idx"].tolist(), pp["rank"].tolist()))
    centre_equal = all(k in ia and pw["frame_center"][ia[k]] == pp["frame_center"][i] for i, k in enumerate(keys))
    log(f"[6] {label} RT-windowed vs whole run: absolute frame_center equal {centre_equal} ({card})")
    if not centre_equal:
        raise AssertionError(f"{label}: RT-windowed frame_center differs from the whole run")
    check_same_psms(label, "RT-windowed vs whole-run PSMs", pw, pp, card)


# ---------------------------------------------------------------------------
# 7. the per-run workflow
# ---------------------------------------------------------------------------
def pass_of(kw) -> str:
    """The pass that made a recorded launch: scoring reads the m/z plane too."""
    return "scoring" if kw.get("with_mz") else "selection"


def launch_count(calls, stage, pass_name) -> int:
    return sum(1 for st, _, kw in calls if st == stage and pass_of(kw) == pass_name)


def kept_bytes(calls) -> int:
    """Bytes of the recorded launches' own argument tensors (the peak store
    and the cell index are the run's, shared by every launch)."""
    import torch

    seen = {}
    for _, args, kw in calls:
        for t in (*args[2:], *kw.values()):
            if isinstance(t, torch.Tensor):
                seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def summed_device_ms(calls, flush, reps=KERNEL_REPS) -> dict:
    """Per pass of the workflow ((``steps`` or ``extraction``, selection or
    scoring)) the launches, their summed device ms, each launch run again
    alone on the card, warm (KERNEL_REPS back to back) and after an L2 flush
    (median), and their bound in ms, as phase [5] counts it. CUDA events
    around a launch inside the run would also count the host's time in the
    wrapper while the card waits for it."""
    from alphadia_torch.ops.xic_cuda import extract_xic_cuda

    acc = {}
    for stage, args, kw in calls:
        def kernel():
            return extract_xic_cuda(*args, **kw)

        a = acc.setdefault(("steps" if stage.startswith("step") else stage, pass_of(kw)), dict.fromkeys(
            ("launches", "ms", "flushed_ms", "bytes", "ops"), 0
        ))
        b, o = work(args, kw)
        a["launches"] += 1
        a["ms"] += device_ms(kernel, reps)
        a["flushed_ms"] += device_ms_flushed(kernel, reps, flush)
        a["bytes"] += b
        a["ops"] += o
    for a in acc.values():
        a["bound_ms"] = max(a["bytes"] / HBM_BYTES_PER_S, a["ops"] / FP32_OPS_PER_S) * 1e3
    return acc


def workflow_config(out_dir):
    from alphadia_torch.config import load_default_config

    cfg = load_default_config()
    cfg.update_layer(
        {"output_directory": str(out_dir), "general": {"random_state": WF_RANDOM_STATE, "save_figures": False}},
        name="chip_smoke",
    )
    return cfg


def fragment_bias_error(wf, planted_ppm) -> float:
    """|median ppm shift of the fitted fragment m/z calibration over the
    library's fragments - the planted library bias|."""
    est = wf.calibration_manager.get_estimator("fragment", "mz")
    mz = np.asarray(wf.spectral_library.fragment_df["mz_library"], np.float64)
    mz = mz[mz > 0]
    return abs(float(np.median((est.function.predict(mz) - mz) / mz * 1e6)) - planted_ppm)


def phase7(label, tag, spectra, prec, frag, name, card, launches, secs, tmp):
    """The workflow on one world at the default config, from a ``.npz`` raw
    file; prints the steps, the final state, the walls and the kernel's
    launches, and gates the loop, the IDs, the calibration and the kernel's
    first launches of every pass."""
    import torch

    from alphadia_torch.library.speclib import SpecLibFlat
    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.rawdata import load_raw_file, save_npz
    from alphadia_torch.testing.synthetic import SyntheticConfig
    from alphadia_torch.workflow.peptidecentric.extraction_handler import ExtractionHandler
    from alphadia_torch.workflow.peptidecentric.optimization_handler import OptimizationHandler
    from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow

    raw_path = tmp / f"world{tag or '_3d'}.npz"
    save_npz(raw_path, spectra)
    back = load_raw_file(raw_path)
    fields = ("rt", "ms_level", "isolation_lower_mz", "isolation_upper_mz", "peak_start_idx", "peak_stop_idx", "mz", "intensity", "mobility")
    same = all(
        (getattr(back, f) is None and getattr(spectra, f) is None) or np.array_equal(getattr(back, f), getattr(spectra, f))
        for f in fields
    )
    log(f"[7] {label}: raw file {raw_path.name} {raw_path.stat().st_size / 2**20:.1f} MiB, read back equal {same}")
    if not same:
        raise AssertionError(f"{label}: the raw file read back differs from the spectra written")

    cfg = workflow_config(tmp / f"out{tag}")
    n_prec = len(prec["precursor_idx"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    xic_cuda.launches = 0
    process_batch = OptimizationHandler._process_batch

    with Recorder() as rec, MethodTimes(
        [(ExtractionHandler, "select_candidates", "selection"), (ExtractionHandler, "score_and_quantify_candidates", "scoring")]
    ) as mt:
        rec.stage = "load"
        def staged(handler):
            rec.stage = f"step{len(handler.step_log)}"
            return process_batch(handler)

        OptimizationHandler._process_batch = staged
        try:
            t0 = time.perf_counter()
            wf = PeptideCentricWorkflow(f"world{tag or '_3d'}", cfg, quant_path=str(tmp / f"quant{tag}"), random_state=WF_RANDOM_STATE)
            wf.load(str(raw_path), SpecLibFlat(prec, frag))
            wf.search_parameter_optimization()
            rec.stage = "extraction"
            psm, fragments = wf.extraction()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            OptimizationHandler._process_batch = process_batch
    n_launch = xic_cuda.launches
    if n_launch != len(rec.calls):
        raise AssertionError(f"{label}: {n_launch} kernel launches counted, {len(rec.calls)} wrapper calls recorded")
    peak = torch.cuda.max_memory_allocated()
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    per_pass = summed_device_ms(rec.calls, flush)
    del flush
    launches["workflow" + tag] = n_launch
    secs["workflow" + tag] = wall
    timings = {k: v.get("duration", float("nan")) for k, v in wf.timing_manager.timings.items()}
    handler = wf.optimization_handler
    om = wf.optimization_manager
    log(
        f"[7] {label} workflow: {n_prec} precursors; wall {wall:.4f} s: load {timings['load']:.4f} s, optimization "
        f"{timings['optimization']:.4f} s ({len(handler.step_log)} steps), extraction {timings['extraction']:.4f} s "
        f"(selection {mt.seconds.get('selection', 0.0):.4f} s, scoring {mt.seconds.get('scoring', 0.0):.4f} s: "
        f"{n_prec / (mt.seconds.get('selection', 0.0) + mt.seconds.get('scoring', 0.0)):.1f} precursors/s; "
        f"{n_prec / timings['extraction']:.1f} precursors/s with the FDR fit); max_memory_allocated "
        f"{peak / 2**30:.3f} GiB (of which {kept_bytes(rec.calls) / 2**30:.3f} GiB the recorded launches' arguments) "
        f"({name}, {card})"
    )
    for i, st in enumerate(handler.step_log):
        moves = ", ".join(f"{k} {st['before'][k]:.4f} -> {st['after'][k]:.4f}" for k in st["optimizers"])
        log(
            f"[7] {label} step {i}: {moves}; elution groups {st['elution_groups'][0]}-{st['elution_groups'][1]} "
            f"({st['precursors']} precursors), {st['targets_at_1pct']} targets at 1% FDR, classifier version "
            f"{st['classifier_version']}; wall {st['wall']:.4f} s: extraction {st['extraction_wall']:.4f} s, FDR fit "
            f"{st['fdr_wall']:.4f} s, the rest {st['wall'] - st['extraction_wall'] - st['fdr_wall']:.4f} s; "
            f"kernel launches {launch_count(rec.calls, f'step{i}', 'selection')} + "
            f"{launch_count(rec.calls, f'step{i}', 'scoring')}"
            f"{'; converged ' + ', '.join(st['converged']) if st['converged'] else ''}"
        )
    steps_wall = sum(st["wall"] for st in handler.step_log)
    ext = sum(st["extraction_wall"] for st in handler.step_log)
    fit = sum(st["fdr_wall"] for st in handler.step_log)
    final_search = mt.seconds.get("selection", 0.0) + mt.seconds.get("scoring", 0.0)
    log(
        f"[7] {label} where the wall goes: the steps {steps_wall:.4f} s of the optimization's "
        f"{timings['optimization']:.4f} s: extraction {ext:.4f} s ({ext / steps_wall:.3f}), FDR fit {fit:.4f} s "
        f"({fit / steps_wall:.3f}), the rest {steps_wall - ext - fit:.4f} s ({(steps_wall - ext - fit) / steps_wall:.3f}); "
        f"the final extraction {timings['extraction']:.4f} s: selection and scoring {final_search:.4f} s, the FDR and "
        f"the rest {timings['extraction'] - final_search:.4f} s ({name}, {card})"
    )
    log(
        f"[7] {label} final: " + ", ".join(f"{k} {float(getattr(om, k)):.4f}" for k in ("ms1_error", "ms2_error", "rt_error", "mobility_error"))
        + f", score_cutoff {float(om.score_cutoff):.4f}, fwhm_rt {float(om.fwhm_rt):.4f}, fwhm_mobility "
        f"{float(om.fwhm_mobility):.4g}, quad_sigma {tuple(round(float(v), 4) for v in om.quad_sigma)}, quad_delta_mu "
        f"{tuple(round(float(v), 4) for v in om.quad_delta_mu)}, classifier version {om.classifier_version}"
    )
    for group, ests in wf.calibration_manager.groups.items():
        for est_name, est in ests.items():
            m = est.metrics or {}
            log(
                f"[7] {label} calibration {group}.{est_name}: fitted {est.is_fitted}, median accuracy "
                f"{m.get('median_accuracy', float('nan')):.4g}, median precision {m.get('median_precision', float('nan')):.4g}"
            )
    for (stage, pass_name), a in sorted(per_pass.items()):
        log(
            f"[7] {label} kernel, {stage} {pass_name}: {a['launches']} launches, {a['ms']:.4f} ms warm "
            f"({a['bound_ms'] / a['ms']:.2f} of bound), L2 flushed {a['flushed_ms']:.4f} ms, bound {a['bound_ms']:.4f} ms "
            f"({a['bytes'] / 1e6:.2f} MB) ({name}, {card})"
        )
    kernel_ms = sum(a["ms"] for a in per_pass.values())
    bound_ms = sum(a["bound_ms"] for a in per_pass.values())
    log(
        f"[7] {label} kernel: {n_launch} launches in the workflow, summed device time {kernel_ms:.4f} ms warm "
        f"({bound_ms / kernel_ms:.2f} of bound), {sum(a['flushed_ms'] for a in per_pass.values()):.4f} ms L2 flushed, "
        f"bound {bound_ms:.4f} ms (each launch run again alone on the card after the workflow); "
        f"{kernel_ms / (wall * 1e3):.5f} of the workflow's wall ({name}, {card})"
    )

    # the loop ended: the targeted optimizers at their targets, every
    # optimizer converged or the insufficient-precursors branch named
    groups = handler.ordered_optimizers
    not_converged = [o.parameter_name for g in groups for o in g if not o.has_converged]
    if not_converged:
        log(
            f"[7] {label}: not converged within calibration.max_steps {cfg['calibration']['max_steps']}: "
            f"{not_converged}; insufficient precursors {handler.insufficient_precursors}"
        )
        if not handler.insufficient_precursors:
            raise AssertionError(f"{label}: optimizers {not_converged} did not converge")
    for g in groups:
        for o in g:
            target = getattr(o, "target_parameter", None)
            if target is not None and abs(float(getattr(om, o.parameter_name)) - target) > 1e-9 * max(abs(target), 1):
                raise AssertionError(f"{label}: {o.parameter_name} did not reach its target {target}")

    identified, false, n_t, n_d = id_shares(wf.dia_data, prec, psm)
    bias = fragment_bias_error(wf, SyntheticConfig().lib_ppm_bias)
    log(
        f"[7] {label} IDs at 1% FDR: {n_t} targets, {n_d} decoys, {len(fragments['precursor_idx'])} fragments; "
        f"identified share {identified:.4f} (bound {WF_IDENTIFIED_MIN[tag]}); realised false share {false:.4f} "
        f"(bound {WF_FALSE_MAX[tag]}); fragment m/z calibration {bias:.4f} ppm from the planted bias (bound "
        f"{WF_BIAS_MAX_PPM[tag]}) ({name}, {card})"
    )
    if identified < WF_IDENTIFIED_MIN[tag] or false > WF_FALSE_MAX[tag]:
        raise AssertionError(f"{label}: the workflow's IDs at 1% FDR miss their gates")
    if bias > WF_BIAS_MAX_PPM[tag]:
        raise AssertionError(f"{label}: the fragment m/z calibration misses the planted bias")

    return launches_against_plain("[7]", label, rec.calls)


def overflowing_queries(args, kw) -> int:
    """Queries of one launch whose window holds more peaks than ``slab``."""
    _, cell_start, slot, _, _, _ = args
    lo, hi, r0, _ = slabs(args, kw)
    flat = cell_start.reshape(-1)
    return int(((flat[hi].long() - r0 > kw["slab"]) & (slot >= 0)).sum())


def launches_against_plain(phase, label, calls):
    """Launches run again and held against the plain version: each pass's
    first launch of every optimization step and of the final extraction
    (printed one by one), then the later launches, those whose slabs
    overflow first and the rest in a seeded order, while the script's
    plain-version budget (``SAMPLE_PLAIN_BUDGET_S``) lasts; returns the
    largest (abs, rel) error."""
    by_pass = {}
    for i, (stage, args, kw) in enumerate(calls):
        by_pass.setdefault((stage, pass_of(kw)), []).append(i)
    stages = {st for st, _ in by_pass}
    if "extraction" not in stages or not any(st.startswith("step") for st in stages):
        raise AssertionError(f"{label}: the workflow launched the kernel in no step or not in the final extraction")
    first = sorted(idx[0] for idx in by_pass.values())
    later = sorted(set(range(len(calls))) - set(first))
    over = {i: overflowing_queries(*calls[i][1:]) for i in later}
    order = np.random.default_rng(SAMPLE_SEED).permutation(len(later))
    later = sorted((i for i in np.asarray(later, np.int64)[order].tolist()), key=lambda i: over[i] == 0)
    worst, held_later, overflowing = [0.0, 0.0], 0, 0
    for i in first + later:
        if i not in over or PLAIN_SAMPLES["spent_s"] <= SAMPLE_PLAIN_BUDGET_S:
            stage, args, kw = calls[i]
            t0 = time.perf_counter()
            res = compare(args, kw)
            B, Q = args[2].shape
            for plane, (mabs, mrel, bad, _) in zip(("intensity", "mz"), res):
                if i not in over:
                    log(
                        f"{phase} {label} {stage:10s} {pass_of(kw):9s} {variant(kw):13s} B={B} Q={Q} "
                        f"W={kw['window_len']} {plane:9s} max_abs={mabs:.3g} max_rel={mrel:.3g} outside_tol={bad}"
                    )
                if bad:
                    raise AssertionError(
                        f"{label}: kernel disagrees with the plain version: {stage} {pass_of(kw)} launch {i} {plane}"
                    )
                worst = [max(worst[0], mabs), max(worst[1], mrel)]
            if i in over:
                PLAIN_SAMPLES["spent_s"] += time.perf_counter() - t0
                held_later += 1
                overflowing += over[i] > 0
    PLAIN_SAMPLES["held"] += len(first) + held_later
    PLAIN_SAMPLES["launches"] += len(calls)
    log(
        f"{phase} {label}: {len(first) + held_later} of {len(calls)} launches held against the plain version (each "
        f"pass's first {len(first)}, later {held_later} of {len(over)}, {overflowing} of them with overflowing slabs); "
        f"max_abs={worst[0]:.3g} max_rel={worst[1]:.3g}; the later ones' plain-version time so far "
        f"{PLAIN_SAMPLES['spent_s']:.2f} s of {SAMPLE_PLAIN_BUDGET_S} s"
    )
    return worst


def workflow_card_vs_cpu(root, tmp, name, card):
    """The workflow on the small 3D world of the CPU tests, on the card and
    on the CPU: the same steps per optimizer, tolerances within
    WF_TOL_REL, target IDs at 1% with a Jaccard overlap >= WF_JACCARD_MIN."""
    sys.path.insert(0, str(root / "tests"))
    from torch_workflow_worlds import compare_runs, run_port

    runs = {}
    for device in (DEVICE, "cpu"):
        path = tmp / f"small_{device}"
        path.mkdir()
        runs[device] = run_port(path, "3d", device, random_state=WF_RANDOM_STATE)
    cmp = compare_runs(runs[DEVICE][:2], runs["cpu"][:2])
    log(
        f"[7] workflow, card vs CPU on the small 3D world: steps {cmp['steps'][0]} / {cmp['steps'][1]}; largest "
        f"tolerance difference {cmp['tolerance_rel']:.4g} (bound {WF_TOL_REL}); IDs at 1% {cmp['ids'][0]} / "
        f"{cmp['ids'][1]}, Jaccard {cmp['jaccard']:.4f} (bound {WF_JACCARD_MIN}); walls card "
        f"{runs[DEVICE][0].wall:.4f} s, CPU {runs['cpu'][0].wall:.4f} s ({name}, {card})"
    )
    if cmp["steps"][0] != cmp["steps"][1] or cmp["tolerance_rel"] > WF_TOL_REL or cmp["jaccard"] < WF_JACCARD_MIN:
        raise AssertionError("the workflow on the card disagrees with the workflow on the CPU")


# ---------------------------------------------------------------------------
# 8. the search step
# ---------------------------------------------------------------------------
def same_frame(a: dict, b: dict) -> bool:
    """Equal column names, order, dtypes (text as object) and values."""
    if list(a) != list(b):
        return False
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype.kind in "OU" or y.dtype.kind in "OU":
            if x.dtype.kind not in "OU" or y.dtype.kind not in "OU" or list(map(str, x)) != list(map(str, y)):
                return False
        elif x.dtype != y.dtype or not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
            return False
    return True


def mzml_round_trip(label, spectra, raw_path):
    """Writes the spectra as mzML with the port's writer and reads them back
    with ``load_raw_file``: the walls, the size, and every array equal bit
    for bit (raises if not)."""
    from alphadia_torch.rawdata import load_raw_file
    from alphadia_torch.testing.mzml_writer import write_mzml

    t0 = time.perf_counter()
    write_mzml(raw_path, spectra)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_raw_file(raw_path)
    t_read = time.perf_counter() - t0
    fields = ("rt", "ms_level", "isolation_lower_mz", "isolation_upper_mz", "peak_start_idx", "peak_stop_idx", "mz", "intensity", "mobility")
    same = all(
        (getattr(back, f) is None and getattr(spectra, f) is None)
        or (getattr(back, f) is not None and getattr(spectra, f) is not None
            and getattr(back, f).dtype == getattr(spectra, f).dtype and np.array_equal(getattr(back, f), getattr(spectra, f)))
        for f in fields
    )
    n_peaks = len(spectra.mz)
    log(
        f"[8] {label} reader: {raw_path.name} {raw_path.stat().st_size / 2**20:.1f} MiB, {spectra.n_spectra} spectra, "
        f"{n_peaks} peaks; written in {t_write:.4f} s, read in {t_read:.4f} s "
        f"({raw_path.stat().st_size / t_read / 2**20:.1f} MiB/s, {n_peaks / t_read:.0f} peaks/s); "
        f"every array equal bit for bit {same}"
    )
    if not same:
        raise AssertionError(f"{label}: the mzML read back differs from the spectra written")


def phase8(root, label, tag, spectra, prec, frag, name, card, launches, secs, tmp, batch_size=None):
    """``SearchStep`` from an mzML file and a TSV transition list on one
    world: the reader, the library build, the workflow and the parquet
    files, each timed; gates the spectra read back, the files, the IDs at
    1% FDR and the kernel's first launches of every pass."""
    import torch

    import alphadia_torch.library.loader as loader
    import alphadia_torch.rawdata.mzml as mzml
    import alphadia_torch.search_step as search_step
    from alphadia_torch.library.decoy import DecoyGenerator
    from alphadia_torch.library.flatten import FlattenLibrary, InitFlatColumns
    from alphadia_torch.library.harmonize import IsotopeGenerator, PrecursorInitializer, RTNormalization
    from alphadia_torch.library.speclib import SpecLibBase
    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.testing.tsv_library import write_transition_list
    from alphadia_torch.utils.parquet import read_parquet
    from alphadia_torch.workflow.managers import raw_file_manager
    from alphadia_torch.workflow.peptidecentric.optimization_handler import OptimizationHandler

    sys.path.insert(0, str(root / "tests"))
    from torch_workflow_worlds import search_id_shares

    raw_path, lib_path = tmp / f"run{tag or '_3d'}.mzML", tmp / f"library{tag or '_3d'}.tsv"
    mzml_round_trip(label, spectra, raw_path)
    targets = np.nonzero(prec["decoy"] == 0)[0]
    truth = {k: v[targets] for k, v in prec.items()}
    write_transition_list(lib_path, truth, frag)
    log(f"[8] {label} library: {lib_path.name} {lib_path.stat().st_size / 2**20:.1f} MiB, {len(targets)} target precursors")

    captured = {}
    workflow_cls = search_step.PeptideCentricWorkflow
    process_batch = OptimizationHandler._process_batch

    class Captured(workflow_cls):
        def load(self, *a, **k):
            rec.stage = "load"
            captured["wf"] = self
            return super().load(*a, **k)

        def extraction(self):
            rec.stage = "extraction"
            captured["frames"] = super().extraction()
            return captured["frames"]

    def staged(handler):
        rec.stage = f"step{len(handler.step_log)}"
        return process_batch(handler)

    timed = [
        (mzml, "read_mzml", "reader"), (loader, "load_speclib_tsv", "tsv"),
        (PrecursorInitializer, "forward", "harmonize"), (IsotopeGenerator, "forward", "harmonize"),
        (RTNormalization, "forward", "harmonize"), (SpecLibBase, "hash_precursors", "hashing"),
        (DecoyGenerator, "forward", "decoys"), (FlattenLibrary, "forward", "flatten"), (InitFlatColumns, "forward", "flatten"),
        (search_step.SearchStep, "load_library", "library"), (search_step, "write_parquet", "parquet"),
        (raw_file_manager, "save_spectra_hdf", "cache_write"), (raw_file_manager, "read_alpharaw_hdf", "cache_read"),
    ]
    out = tmp / f"search{tag or '_3d'}"
    config = {
        "library_path": str(lib_path), "raw_paths": [str(raw_path)],
        "general": {"random_state": WF_RANDOM_STATE, "save_figures": False, "log_level": "PROGRESS"},
    }
    if batch_size is not None:
        config["calibration"] = {"batch_size": batch_size}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    search_step.PeptideCentricWorkflow = Captured
    OptimizationHandler._process_batch = staged
    try:
        with Recorder() as rec, MethodTimes(timed) as mt:
            xic_cuda.launches = 0
            t0 = time.perf_counter()
            step = search_step.SearchStep(str(out), config=config)
            step.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_launch = xic_cuda.launches
    finally:
        search_step.PeptideCentricWorkflow = workflow_cls
        OptimizationHandler._process_batch = process_batch
    if step.errors:
        raise AssertionError(f"{label}: the search step failed: {step.errors}")
    if n_launch != len(rec.calls) or n_launch == 0:
        raise AssertionError(f"{label}: {n_launch} kernel launches counted, {len(rec.calls)} wrapper calls recorded")
    peak = torch.cuda.max_memory_allocated()
    launches["search_step" + tag] = n_launch
    secs["search_step" + tag] = wall
    wf = captured["wf"]
    psm, fragments = captured["frames"]
    lib = step.spectral_library
    timings = {k: v.get("duration", float("nan")) for k, v in wf.timing_manager.timings.items()}
    s = mt.seconds
    log(
        f"[8] {label} search step: wall {wall:.4f} s; library {s['library']:.4f} s (TSV parse {s['tsv']:.4f} s, "
        f"harmonize {s['harmonize']:.4f} s of which hashing {s['hashing']:.4f} s, decoys {s['decoys']:.4f} s, "
        f"flatten {s['flatten']:.4f} s): {len(lib.precursor_df['precursor_idx'])} precursors, "
        f"{len(lib.fragment_df['mz_library'])} fragments after flattening; workflow load {timings['load']:.4f} s "
        f"(of which the mzML reader {cache_split({k.replace('reader', 'parse'): v for k, v in s.items()})}), optimization {timings['optimization']:.4f} s "
        f"({len(wf.optimization_handler.step_log)} steps), extraction {timings['extraction']:.4f} s; parquet writes "
        f"{s['parquet']:.4f} s; max_memory_allocated {peak / 2**30:.3f} GiB ({name}, {card})"
    )

    quant = out / "quant" / raw_path.stem
    files = {f: (quant / f).exists() for f in ("psm.parquet", "frag.parquet")}
    files["frozen_config.yaml"] = (out / "frozen_config.yaml").exists()
    same_psm = files["psm.parquet"] and same_frame(read_parquet(quant / "psm.parquet"), psm)
    same_frag = files["frag.parquet"] and same_frame(read_parquet(quant / "frag.parquet"), fragments)
    log(
        f"[8] {label} files: {files}; psm.parquet {(quant / 'psm.parquet').stat().st_size / 2**20:.2f} MiB read back "
        f"equal {same_psm}, frag.parquet {(quant / 'frag.parquet').stat().st_size / 2**20:.2f} MiB read back equal {same_frag}"
    )
    if not all(files.values()) or not same_psm or not same_frag:
        raise AssertionError(f"{label}: the search step's files are missing or differ from its frames")

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    per_pass = summed_device_ms(rec.calls, flush)
    del flush
    for (stage, pass_name), a in sorted(per_pass.items()):
        log(
            f"[8] {label} kernel, {stage} {pass_name}: {a['launches']} launches, {a['ms']:.4f} ms warm "
            f"({a['bound_ms'] / a['ms']:.2f} of bound), L2 flushed {a['flushed_ms']:.4f} ms, bound {a['bound_ms']:.4f} ms "
            f"({a['bytes'] / 1e6:.2f} MB) ({name}, {card})"
        )
    kernel_ms = sum(a["ms"] for a in per_pass.values())
    log(
        f"[8] {label} kernel: {n_launch} launches in the search step, summed device time {kernel_ms:.4f} ms warm, "
        f"bound {sum(a['bound_ms'] for a in per_pass.values()):.4f} ms; {kernel_ms / (wall * 1e3):.5f} of the step's "
        f"wall ({name}, {card})"
    )

    identified, false, n_t, n_d = search_id_shares(wf.dia_data.cycle_rt, truth, psm)
    rt_error = float(wf.optimization_manager.rt_error)
    log(
        f"[8] {label} IDs at 1% FDR: {n_t} targets, {n_d} decoys, {len(fragments['precursor_idx'])} fragments; "
        f"identified share {identified:.4f} (bound {SS_IDENTIFIED_MIN[tag]}); realised false share {false:.4f} "
        f"(bound {SS_FALSE_MAX[tag]}); final ms2_error {float(wf.optimization_manager.ms2_error):.4f}, rt_error "
        f"{rt_error:.4f} (bound {SS_RT_ERROR_MAX[tag]}); FDR classifier versions trained "
        f"{len(wf.fdr_manager.classifier_store)} ({name}, {card})"
    )
    if identified < SS_IDENTIFIED_MIN[tag] or false > SS_FALSE_MAX[tag]:
        raise AssertionError(f"{label}: the search step's IDs at 1% FDR miss their gates")
    if rt_error > SS_RT_ERROR_MAX[tag]:
        raise AssertionError(f"{label}: the RT tolerance did not converge ({rt_error:.4f} s)")
    if not wf.fdr_manager.classifier_store:
        raise AssertionError(f"{label}: every FDR fit fell back to logistic regression")
    return launches_against_plain("[8]", label, rec.calls)


# phase [9], the CLI on two runs: the JAX package's CLI on the CPU on the
# same inputs (two runs of the search step's quarter 3D world from
# sequences, acquisition seeds 101 / 202, intensity 1.0 / 1.6, RT shift 0 /
# 4 s, a TSV library whose ~4 peptides a protein and 10% shared peptides
# give grouping and parsimony work) at random states 0, 1 and 2
# (`PYTHONPATH=.:tests python tests/test_torch_cli.py --random-state 0 1 2`;
# a JAX CLI run of two bench-size runs on a CPU is too large to take as a
# reading, so the card reads that same quarter world). Gates: identified at least the least
# less 0.005 and false at most max(0.02, the largest + 0.005) per run, as
# phase [8]; protein groups at 1% protein FDR and the groups each LFQ level
# quantifies within 2% of JAX's band; the run-to-run log2 ratio of
# pg.matrix: its median within 0.05 of JAX's band, its MAD within 20%
CLI_JAX_READINGS = {  # random states 0, 1, 2
    "identified_run_0": [0.9984114376489277, 0.9984114376489277, 0.9984114376489277],
    "false_run_0": [0.0367816091954023, 0.03456221198156682, 0.03896103896103896],
    "identified_run_1": [1.0, 1.0, 1.0],
    "false_run_1": [0.027906976744186046, 0.03018575851393189, 0.021756021756021756],
    "protein_groups": [520, 522, 519],
    "groups_precursor": [1318, 1320, 1320], "groups_peptide": [1318, 1320, 1320], "groups_pg": [520, 522, 519],
    "log2_ratio_median": [-0.004040286891067104, -0.004040286891067184, -0.005139640275093222],
    "log2_ratio_mad": [0.007717596835504182, 0.007775617836572698, 0.007151834945107084],
}
CLI_REL_BAND = 0.02
CLI_RATIO_MEDIAN_TOL = 0.05
CLI_RATIO_MAD_REL = 0.20
CLI_TOL_REL = 0.05


def band(values, rel=0.0, add=0.0):
    """[least, largest] of ``values`` widened by ``rel`` of themselves and
    by ``add``."""
    return min(values) * (1 - rel) - add, max(values) * (1 + rel) + add


def spectra_cache_times() -> MethodTimes:
    """Host seconds of an mzML read through ``RawFileManager``: the XML
    parse, and the spectra cache's write or read."""
    from alphadia_torch.rawdata import mzml
    from alphadia_torch.workflow.managers import raw_file_manager

    return MethodTimes([(mzml, "read_mzml", "parse"), (raw_file_manager, "save_spectra_hdf", "cache_write"),
                        (raw_file_manager, "read_alpharaw_hdf", "cache_read")])


def cache_split(s) -> str:
    if "cache_read" in s and "parse" not in s:
        return f"a cache read, {s['cache_read']:.4f} s"
    return (f"a parse, {s.get('parse', 0.0):.4f} s, and the cache written in {s.get('cache_write', 0.0):.4f} s"
            + (f" (and a cache read of {s['cache_read']:.4f} s)" if "cache_read" in s else ""))


def phase9(root, name, card, launches, secs, tmp):
    """``alphadia-torch`` (``cli.run``) on two runs at the default config,
    on the card: the walls (library build, each run's search step,
    ``SearchPlanOutput.build`` and its stages), the kernel's launches per
    run (each pass's first launch of every step held against the plain
    version), the cross-run tables read back, and the gates above."""
    import logging

    import torch

    import alphadia_torch.cli as cli
    import alphadia_torch.search_step as search_step
    from alphadia_torch.library.loader import load_speclib_hdf
    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.outputs.search_plan_output import SearchPlanOutput
    from alphadia_torch.utils.parquet import read_parquet
    from alphadia_torch.utils.tsv import read_tsv
    from alphadia_torch.workflow.peptidecentric.optimization_handler import OptimizationHandler

    sys.path.insert(0, str(root / "tests"))
    from torch_workflow_worlds import CLI_WORLD, cli_readings, write_cli_inputs

    t0 = time.perf_counter()
    (tmp / "cli_inputs").mkdir()
    raws, lib, truth, cycle_rts = write_cli_inputs(tmp / "cli_inputs", CLI_WORLD)
    shared = np.mean([";" in p for p in truth["proteins"]])
    log(
        f"[9] inputs: {len(raws)} runs of {CLI_WORLD['n_peptides']} peptides, {CLI_WORLD['n_windows']} windows, "
        f"{CLI_WORLD['n_cycles']} cycles as mzML ({sum(r.stat().st_size for r in raws) / 2**20:.1f} MiB), library "
        f"{lib.stat().st_size / 2**20:.1f} MiB: {len(set(';'.join(truth['proteins']).split(';')))} proteins, "
        f"{shared:.3f} of the peptides shared; made in {time.perf_counter() - t0:.2f} s"
    )

    captured = {"runs": [], "walls": []}
    workflow_cls = search_step.PeptideCentricWorkflow
    process_batch = OptimizationHandler._process_batch
    process_raw = search_step.SearchStep._process_raw_file
    load_library = search_step.SearchStep.load_library
    build = SearchPlanOutput.build

    class Captured(workflow_cls):
        def load(self, *a, **k):
            rec.stage = "load"
            captured["runs"].append((self, len(rec.calls)))
            return super().load(*a, **k)

        def extraction(self):
            rec.stage = "extraction"
            return super().extraction()

    def staged(handler):
        rec.stage = f"step{len(handler.step_log)}"
        return process_batch(handler)

    def timed_raw(self, *a, **k):
        t = time.perf_counter()
        try:
            return process_raw(self, *a, **k)
        finally:
            torch.cuda.synchronize()
            captured["walls"].append(time.perf_counter() - t)

    def timed_library(self):
        t = time.perf_counter()
        out = load_library(self)
        captured["library_s"] = time.perf_counter() - t
        return out

    def kept_build(self, *a, **k):
        captured["output"] = self
        return build(self, *a, **k)

    import alphadia_torch.fdr.fdr as fdr_mod

    plot_fdr = fdr_mod._plot_fdr

    def timed_plot(*a, **k):  # each FDR fit's fdr.png, by the run being searched
        t = time.perf_counter()
        try:
            return plot_fdr(*a, **k)
        finally:
            FDR_FIGURES["calls"].append((len(captured["runs"]) - 1, time.perf_counter() - t))

    class Count(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.mbr = []

        def emit(self, record):
            if "could not build MBR library" in record.getMessage():
                self.mbr.append(record.getMessage())

    counter = Count()
    output_logger = logging.getLogger("alphadia_torch.outputs.search_plan_output")
    output_logger.addHandler(counter)
    out = tmp / "cli_out"
    argv = ["-o", str(out), "-f", str(raws[0]), "-f", str(raws[1]), "-l", str(lib), "--config-dict",
            json.dumps({"general": {"random_state": 0, "log_level": "PROGRESS"}})]
    search_step.PeptideCentricWorkflow = Captured
    OptimizationHandler._process_batch = staged
    search_step.SearchStep._process_raw_file = timed_raw
    search_step.SearchStep.load_library = timed_library
    SearchPlanOutput.build = kept_build
    fdr_mod._plot_fdr = timed_plot
    code = 0
    try:
        with Recorder() as rec, spectra_cache_times() as ct:
            torch.cuda.synchronize()
            xic_cuda.launches = 0
            t0 = time.perf_counter()
            try:
                cli.run(argv)
            except SystemExit as e:
                code = e.code
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_launch = xic_cuda.launches
    finally:
        search_step.PeptideCentricWorkflow = workflow_cls
        OptimizationHandler._process_batch = process_batch
        search_step.SearchStep._process_raw_file = process_raw
        search_step.SearchStep.load_library = load_library
        SearchPlanOutput.build = build
        fdr_mod._plot_fdr = plot_fdr
        output_logger.removeHandler(counter)
    log(f"[9] the runs' mzML: {cache_split(ct.seconds)} ({name}, {card})")
    log(f"[9] alphadia-torch {' '.join(a if len(a) < 60 else '...' for a in argv)}: exit {code}, wall {wall:.4f} s")
    if code != 0:
        raise AssertionError(f"the CLI exited {code}")
    if n_launch != len(rec.calls) or n_launch == 0:
        raise AssertionError(f"CLI: {n_launch} kernel launches counted, {len(rec.calls)} wrapper calls recorded")
    if len(captured["runs"]) != 2:
        raise AssertionError(f"CLI: {len(captured['runs'])} runs searched")

    t = captured["output"].timings
    log(
        f"[9] walls: library build {captured['library_s']:.4f} s; search step run_0 {captured['walls'][0]:.4f} s, "
        f"run_1 {captured['walls'][1]:.4f} s; SearchPlanOutput.build {t['build_s']:.4f} s: read {t['read_s']:.4f} s, "
        f"grouping {t['grouping_s']:.4f} s, protein FDR {t['protein_fdr_s']:.4f} s (MLP fit {t.get('mlp_fit_s', np.nan):.4f} "
        f"s, {t.get('mlp_epochs')} epochs), stat and internal {t['stat_internal_s']:.4f} s, LFQ "
        + ", ".join(f"{lv} {t[f'lfq_{lv}_s']:.4f} s ({t[f'lfq_{lv}_groups']} groups)" for lv in ("precursor", "peptide", "pg"))
        + f", MBR library {t['mbr_s']:.4f} s, precursors write {t['write_precursors_s']:.4f} s ({name}, {card})"
    )

    files = ("precursors.parquet", "pg.matrix.parquet", "precursor.matrix.parquet", "peptide.matrix.parquet", "stat.tsv",
             "internal.tsv")
    rows = {}
    for f in files:
        if not (out / f).exists():
            raise AssertionError(f"CLI: {f} is missing")
        frame = read_tsv(out / f) if f.endswith(".tsv") else read_parquet(out / f)
        rows[f] = len(next(iter(frame.values())))
    mbr_lib = load_speclib_hdf(out / "speclib.mbr.hdf")
    log(
        f"[9] files read back (rows): {json.dumps(rows)}; the MBR library speclib.mbr.hdf read back: "
        f"{len(mbr_lib.precursor_df['precursor_idx'])} precursors; MBR warnings {len(counter.mbr)}: {counter.mbr[:1]}"
    )
    if counter.mbr:
        raise AssertionError("CLI: the MBR library could not be built or written")

    worst = [0.0, 0.0]
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    starts = [i for _, i in captured["runs"]] + [len(rec.calls)]
    for r, (a, b) in enumerate(zip(starts[:-1], starts[1:])):
        calls = rec.calls[a:b]
        launches[f"cli_run_{r}"] = len(calls)
        w = launches_against_plain("[9]", f"run_{r}", calls)
        worst = [max(worst[0], w[0]), max(worst[1], w[1])]
        per_pass = summed_device_ms(calls, flush)
        for (stage, pass_name), acc in sorted(per_pass.items()):
            log(
                f"[9] run_{r} kernel, {stage} {pass_name}: {acc['launches']} launches, {acc['ms']:.4f} ms warm "
                f"({acc['bound_ms'] / acc['ms']:.2f} of bound), L2 flushed {acc['flushed_ms']:.4f} ms, bound "
                f"{acc['bound_ms']:.4f} ms ({acc['bytes'] / 1e6:.2f} MB) ({name}, {card})"
            )
        log(
            f"[9] run_{r} kernel: {len(calls)} launches, summed {sum(x['ms'] for x in per_pass.values()):.4f} ms warm, "
            f"bound {sum(x['bound_ms'] for x in per_pass.values()):.4f} ms ({name}, {card})"
        )
    del flush
    secs["cli"] = wall
    FDR_FIGURES.update(out=out, run_walls=list(captured["walls"]), cli_wall=wall)

    got = cli_readings(out, truth, cycle_rts)
    jax = CLI_JAX_READINGS
    checks = cli_id_checks(got)
    for k in ("groups_precursor", "groups_peptide", "groups_pg"):
        checks.append((k, got[k], band(jax[k], rel=CLI_REL_BAND)))
    checks.append(("log2_ratio_median", got["log2_ratio_median"], band(jax["log2_ratio_median"], add=CLI_RATIO_MEDIAN_TOL)))
    checks.append(("log2_ratio_mad", got["log2_ratio_mad"], band(jax["log2_ratio_mad"], rel=CLI_RATIO_MAD_REL)))

    # the tolerances in stat.tsv: each run's within 5% of its workflow's own
    # final state, and run 0's within 5% of the card's own search step on
    # run 0 alone (phase [8]'s kind of reading: the same inputs and random
    # state, so the CLI's first run repeats it; the RT optimizer's outcome
    # is bimodal across runs, JAX's run 0 / run 1 at random state 0: 196.2983
    # / 33.7868 s, so the runs are not held to each other)
    single = search_step.SearchStep(str(tmp / "cli_single"), config={
        "library_path": str(lib), "raw_paths": [str(raws[0])], "general": {"random_state": 0, "log_level": "PROGRESS"}})
    with spectra_cache_times() as ct:
        single.run()
    log(f"[9] the single step's read of run_0.mzML: {cache_split(ct.seconds)} ({name}, {card})")
    stat = read_tsv(tmp / "cli_single" / "stat.tsv")
    for r, (wf, _) in enumerate(captured["runs"]):
        for k in ("ms1_error", "ms2_error", "rt_error"):
            refs = [("workflow", float(getattr(wf.optimization_manager, k)))]
            if r == 0:
                refs.append(("single step", float(stat[f"optimization.{k}"][0])))
            for what, ref in refs:
                checks.append((f"{k}_run_{r} against its {what}", got[f"{k}_run_{r}"],
                               (ref * (1 - CLI_TOL_REL), ref * (1 + CLI_TOL_REL))))
    failed = []
    for k, v, (lo, hi) in checks:
        ok = lo <= v <= hi
        log(f"[9] gate {k}: {v:.4f} in [{lo:.4f}, {hi:.4f}] {'ok' if ok else 'FAILED'} ({name}, {card})")
        if not ok:
            failed.append(k)
    if failed:
        raise AssertionError(f"CLI: gates failed: {failed}")
    return worst, (raws, lib, truth, cycle_rts)


def cli_id_checks(got: dict) -> list:
    """Phase [9]'s gates on the IDs per run and the protein groups of a CLI
    run on its inputs (``cli_readings``), against the JAX band."""
    jax = CLI_JAX_READINGS
    checks = []
    for r in range(2):
        lo = min(jax[f"identified_run_{r}"]) - 0.005
        hi = max(0.02, max(jax[f"false_run_{r}"]) + 0.005)
        checks += [(f"identified_run_{r}", got[f"identified_run_{r}"], (lo, 1.0)),
                   (f"false_run_{r}", got[f"false_run_{r}"], (0.0, hi))]
    checks.append(("protein_groups", got["protein_groups"], band(jax["protein_groups"], rel=CLI_REL_BAND)))
    return checks


# ---------------------------------------------------------------------------
# 10. library-free search
# ---------------------------------------------------------------------------
# phase [10a], the CLI library-free on one run: the inputs are made on the
# host by the port's CPU path (tests/torch_workflow_worlds.
# write_library_free_inputs: a seeded FASTA of 20 proteins with the human
# proteome's residue composition and lengths, whose digest at the default
# library_prediction settings gives 3,172 target precursors; the packaged
# models' library in float64 planted in 3 windows, 600 cycles, 80 noise
# peaks, 0.9 detectable, seed 5; the mzML uncompressed), so every machine
# writes the same bytes: the sha256 below are the files the JAX readings
# searched. The JAX package's CLI on the CPU read, at random states 0, 1
# and 2 (`PYTHONPATH=.:tests python tests/test_torch_prediction.py
# --random-state 0 1 2`), the readings below. Gates, as phase [8]: identified
# at least the least less 0.005, false at most 0.02 or the largest + 0.005;
# the protein groups within 2% of JAX's band; the predicted library on the
# card against the same library predicted on the CPU at atol 1e-4
LF_FASTA_SHA256 = "78c49b673ca6ee594498a03ac9ffd239006d0710e93b7b124894db17271fe2d7"
LF_MZML_SHA256 = "563eb69742d948cee1d5107c12cf6f140f543be94bfe3c0bde9a3bde570805bd"
LF_JAX_READINGS = {  # random states 0, 1, 2
    "identified": [0.8404628330995793, 0.8380084151472651, 0.8355539971949509],
    "false": [0.22464898595943839, 0.23989113530326595, 0.23699648025029332],
    "protein_groups": [20, 20, 20],
}
LF_REL_BAND = 0.02
LF_PREDICTION_ATOL = 1e-4
# phase [10b]: the human reference proteome's count of canonical proteins
# (UniProt UP000005640), the card against the CPU on the first precursors,
# and the phase's aim in seconds, by which SimplePrediction.forward is cut
# (120 s until the figures and the GUI of phase [16] took their share of the
# script's time, 60 s until phase [17] did)
PROTEOME_PREDICTION_CHECK = 20000
PROTEOME_BUDGET_S = 40.0
PROTEOME_FORWARD_PROBE = 100000
# Cut for the script's time, which went to phase [15] (the script took
# 1,038-1,061 s of its 1,200 on slow hosts of the H100 machine): the digest
# covers a quarter of the proteome's proteins (the whole, 4,308,409
# precursors, took 50.8-76.9 s on one host thread there: its rate is per
# protein), and the four models run on its leading 2**18 precursors (32
# batches of 8192; over the whole digest 18-22 s of host wall each for
# ~1.2 s on the card). Until phase [17] the models ran on 2**20 and the
# phase aimed at 60 s; with [17] the script took 1,178 s of its 1,200 on a
# slow host (7.2 s of host wall a model there, the phase 59.4 s)
PROTEOME_DIGEST_PROTEINS = 5100
PROTEOME_MODEL_ROWS = 1 << 18


class ModelTimes:
    """The property models' work while it is active: the host wall and rows
    of each ``FinetuneManager.predict_*`` call, and CUDA events around each
    batch's forward on the card (their sum is the model's device ms; the
    gaps between a batch's kernels count, the host's encoding and copies
    between batches do not)."""

    METHODS = (("predict_rt", "rt"), ("predict_ms2", "ms2"), ("predict_mobility", "ccs"), ("predict_charge", "charge"))

    def __enter__(self):
        import torch

        from alphadia_torch.models import finetune
        from alphadia_torch.models.property_models import MODEL_OF

        self.wall, self.rows, self.events, self._patched = {}, {}, {}, []
        for method, model in self.METHODS:
            orig = getattr(finetune.FinetuneManager, method)

            def timed(mgr, *a, _orig=orig, _model=model, **k):
                t = time.perf_counter()
                out = _orig(mgr, *a, **k)
                self.wall[_model] = self.wall.get(_model, 0.0) + time.perf_counter() - t
                self.rows[_model] = self.rows.get(_model, 0) + len(out)
                return out

            self._patched.append((finetune.FinetuneManager, method, orig))
            setattr(finetune.FinetuneManager, method, timed)
        for model, cls in MODEL_OF.items():
            orig = cls.forward

            def forward(module, *a, _orig=orig, _model=model, **k):
                if not next(module.parameters()).is_cuda:
                    return _orig(module, *a, **k)
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                out = _orig(module, *a, **k)
                e.record()
                self.events.setdefault(_model, []).append((s, e))
                return out

            self._patched.append((cls, "forward", orig))
            cls.forward = forward
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._patched):
            setattr(owner, attr, orig)

    def device_ms(self, model) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events.get(model, []))


def predicted_columns_against_cpu(label, card_lib, cpu_lib):
    """The predicted columns of one library on the card against the CPU:
    (largest abs error of rt_norm, mobility, fragment intensities)."""
    err = (
        float(np.abs(card_lib.precursor_df["rt_norm"] - cpu_lib.precursor_df["rt_norm"]).max()),
        float(np.abs(card_lib.precursor_df["mobility"] - cpu_lib.precursor_df["mobility"]).max()),
        float(np.abs(card_lib.fragment_intensity - cpu_lib.fragment_intensity).max()),
    )
    ok = max(err) <= LF_PREDICTION_ATOL and np.array_equal(card_lib.fragment_mz, cpu_lib.fragment_mz)
    log(
        f"{label} predicted library, card against CPU: rt_norm {err[0]:.3g}, mobility {err[1]:.3g}, fragment "
        f"intensities {err[2]:.3g} (max abs; atol {LF_PREDICTION_ATOL}), fragment m/z equal: "
        f"{np.array_equal(card_lib.fragment_mz, cpu_lib.fragment_mz)} {'ok' if ok else 'FAILED'}"
    )
    if not ok:
        raise AssertionError(f"{label}: the predicted library on the card departs from the CPU's")


def phase10a(root, name, card, launches, secs, tmp):
    """``alphadia-torch -f run.mzML --fasta db.fasta`` with
    ``library_prediction.enabled`` on the card: the walls (digest, each
    model's predict, the rest of the library build, the search step, the
    outputs), the predicted library against the CPU's, the kernel's
    launches (each pass's first launch of every step held against the plain
    version) and the gates above."""
    import hashlib

    import torch

    import alphadia_torch.cli as cli
    import alphadia_torch.search_step as search_step
    from alphadia_torch.models.prediction import SimplePrediction
    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.outputs.search_plan_output import SearchPlanOutput
    from alphadia_torch.workflow.peptidecentric.optimization_handler import OptimizationHandler

    sys.path.insert(0, str(root / "tests"))
    from torch_workflow_worlds import LIBRARY_FREE_WORLD, library_free_readings, write_library_free_inputs

    t0 = time.perf_counter()
    d = tmp / "library_free"
    d.mkdir()
    fasta, raw, truth, cycle_rt = write_library_free_inputs(d, LIBRARY_FREE_WORLD)
    sha = {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in (fasta, raw)}
    log(
        f"[10a] inputs: {LIBRARY_FREE_WORLD['n_proteins']} proteins, {len(truth['charge'])} target precursors, "
        f"{int(truth['_truth_detectable'].sum())} planted; {fasta.name} sha256 {sha[fasta.name]}, {raw.name} "
        f"{raw.stat().st_size / 2**20:.1f} MiB sha256 {sha[raw.name]}; made on the host in {time.perf_counter() - t0:.2f} s"
    )
    if (sha[fasta.name], sha[raw.name]) != (LF_FASTA_SHA256, LF_MZML_SHA256):
        raise AssertionError("library-free inputs: not the files of the JAX readings")

    captured = {"walls": []}
    workflow_cls = search_step.PeptideCentricWorkflow
    process_batch = OptimizationHandler._process_batch
    process_raw = search_step.SearchStep._process_raw_file
    load_library = search_step.SearchStep.load_library
    digest = search_step.digest_fasta
    forward = SimplePrediction.forward
    build = SearchPlanOutput.build

    class Captured(workflow_cls):
        def load(self, *a, **k):
            rec.stage = "load"
            return super().load(*a, **k)

        def extraction(self):
            rec.stage = "extraction"
            return super().extraction()

    def staged(handler):
        rec.stage = f"step{len(handler.step_log)}"
        return process_batch(handler)

    def timed_raw(self, *a, **k):
        t = time.perf_counter()
        try:
            return process_raw(self, *a, **k)
        finally:
            torch.cuda.synchronize()
            captured["walls"].append(time.perf_counter() - t)

    def timed_library(self):
        t = time.perf_counter()
        out = load_library(self)
        captured["library_s"] = time.perf_counter() - t
        return out

    def timed_digest(*a, **k):
        t = time.perf_counter()
        out = digest(*a, **k)
        captured["digest_s"] = time.perf_counter() - t
        return out

    def kept_forward(self, lib):
        captured["before_prediction"] = lib.copy()
        out = forward(self, lib)
        captured["predicted"] = out.copy()
        return out

    def timed_build(self, *a, **k):
        t = time.perf_counter()
        try:
            return build(self, *a, **k)
        finally:
            captured["outputs_s"] = time.perf_counter() - t

    out = tmp / "library_free_out"
    argv = ["-o", str(out), "-f", str(raw), "--fasta", str(fasta), "--config-dict",
            json.dumps({"general": {"random_state": 0, "log_level": "PROGRESS"}, "library_prediction": {"enabled": True}})]
    search_step.PeptideCentricWorkflow = Captured
    OptimizationHandler._process_batch = staged
    search_step.SearchStep._process_raw_file = timed_raw
    search_step.SearchStep.load_library = timed_library
    search_step.digest_fasta = timed_digest
    SimplePrediction.forward = kept_forward
    SearchPlanOutput.build = timed_build
    code = 0
    try:
        with Recorder() as rec, ModelTimes() as mt:
            torch.cuda.synchronize()
            xic_cuda.launches = 0
            t0 = time.perf_counter()
            try:
                cli.run(argv)
            except SystemExit as e:
                code = e.code
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_launch = xic_cuda.launches
    finally:
        search_step.PeptideCentricWorkflow = workflow_cls
        OptimizationHandler._process_batch = process_batch
        search_step.SearchStep._process_raw_file = process_raw
        search_step.SearchStep.load_library = load_library
        search_step.digest_fasta = digest
        SimplePrediction.forward = forward
        SearchPlanOutput.build = build
    log(f"[10a] alphadia-torch {' '.join(a if len(a) < 60 else '...' for a in argv)}: exit {code}, wall {wall:.4f} s")
    if code != 0:
        raise AssertionError(f"the library-free CLI exited {code}")
    if n_launch != len(rec.calls) or n_launch == 0:
        raise AssertionError(f"library-free: {n_launch} kernel launches counted, {len(rec.calls)} wrapper calls recorded")
    predict_s = sum(mt.wall.values())
    log(
        f"[10a] walls: digest {captured['digest_s']:.4f} s; "
        + "; ".join(
            f"{m} predict {mt.wall[m]:.4f} s ({mt.rows[m]} precursors, device {mt.device_ms(m):.4f} ms)"
            for _, m in ModelTimes.METHODS if m in mt.wall
        )
        + f"; the rest of the library build {captured['library_s'] - captured['digest_s'] - predict_s:.4f} s (library "
        f"build {captured['library_s']:.4f} s); search step {captured['walls'][0]:.4f} s; outputs "
        f"{captured['outputs_s']:.4f} s ({name}, {card})"
    )
    if set(mt.wall) != {"rt", "ms2", "ccs"}:
        raise AssertionError(f"library-free: the models that ran: {sorted(mt.wall)}")

    cpu_lib = SimplePrediction(device="cpu")(captured["before_prediction"])
    predicted_columns_against_cpu("[10a]", captured["predicted"], cpu_lib)

    calls = rec.calls
    launches["library_free"] = len(calls)
    worst = launches_against_plain("[10a]", "run", calls)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    per_pass = summed_device_ms(calls, flush)
    del flush
    for (stage, pass_name), acc in sorted(per_pass.items()):
        log(
            f"[10a] kernel, {stage} {pass_name}: {acc['launches']} launches, {acc['ms']:.4f} ms warm "
            f"({acc['bound_ms'] / acc['ms']:.2f} of bound), L2 flushed {acc['flushed_ms']:.4f} ms, bound "
            f"{acc['bound_ms']:.4f} ms ({acc['bytes'] / 1e6:.2f} MB) ({name}, {card})"
        )
    log(
        f"[10a] kernel: {len(calls)} launches, summed {sum(x['ms'] for x in per_pass.values()):.4f} ms warm, bound "
        f"{sum(x['bound_ms'] for x in per_pass.values()):.4f} ms ({name}, {card})"
    )
    secs["library_free"] = wall

    got = library_free_readings(out, truth, cycle_rt)
    log(f"[10a] readings: {json.dumps(got)}")
    jax = LF_JAX_READINGS
    checks = [
        ("identified", got["identified"], (min(jax["identified"]) - 0.005, 1.0)),
        ("false", got["false"], (0.0, max(0.02, max(jax["false"]) + 0.005))),
        ("protein_groups", got["protein_groups"], band(jax["protein_groups"], rel=LF_REL_BAND)),
    ]
    failed = []
    for k, v, (lo, hi) in checks:
        ok = lo <= v <= hi
        log(f"[10a] gate {k}: {v:.4f} in [{lo:.4f}, {hi:.4f}] {'ok' if ok else 'FAILED'} ({name}, {card})")
        if not ok:
            failed.append(k)
    if failed:
        raise AssertionError(f"library-free: gates failed: {failed}")
    return worst


def phase10b(name, card, tmp):
    """Prediction at proteome scale: a seeded FASTA of a quarter of the
    human proteome's 20,400 proteins (``PROTEOME_DIGEST_PROTEINS``) digested
    at the default settings, the four models on its leading
    ``PROTEOME_MODEL_ROWS`` precursors on the card (walls,
    device ms, precursors/s, peak memory), the card against the CPU on the
    first precursors, and
    ``SimplePrediction.forward`` over the whole digest or, where its host
    stages would pass the phase's aim, the largest leading share that fits."""
    import torch

    from alphadia_torch.library.digest import digest_fasta
    from alphadia_torch.library.speclib import SpecLibBase
    from alphadia_torch.models.finetune import FinetuneManager
    from alphadia_torch.models.prediction import PACKAGED_MODELS, SimplePrediction
    from alphadia_torch.testing.fasta import HUMAN_PROTEOME_PROTEINS, write_fasta
    from alphadia_torch.utils.frame import take

    t_phase = time.perf_counter()
    fasta = write_fasta(tmp / "proteome.fasta", PROTEOME_DIGEST_PROTEINS, seed=0)
    t0 = time.perf_counter()
    df = digest_fasta([str(fasta)]).precursor_df
    digest_s = time.perf_counter() - t0
    n = len(df["charge"])
    log(
        f"[10b] proteome: {PROTEOME_DIGEST_PROTEINS} of the human proteome's {HUMAN_PROTEOME_PROTEINS} proteins "
        f"({fasta.stat().st_size / 2**20:.1f} MiB FASTA), digest at "
        f"the default settings: {n} precursors in {digest_s:.4f} s ({n / digest_s:.1f} precursors/s, host)"
    )
    k = min(n, PROTEOME_MODEL_ROWS)
    seqs, mods, sites = list(df["sequence"][:k]), list(df["mods"][:k]), list(df["mod_sites"][:k])
    charge = df["charge"][:k].astype(np.int32)
    manager = FinetuneManager.load(PACKAGED_MODELS)  # the card
    on_cpu = FinetuneManager.load(PACKAGED_MODELS, device="cpu")
    m = PROTEOME_PREDICTION_CHECK
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ModelTimes() as mt:
        for method, model in ModelTimes.METHODS:
            args = (seqs, mods, sites, charge) if model in ("ms2", "ccs") else (seqs, mods, sites)
            t0 = time.perf_counter()
            got = getattr(manager, method)(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            dev_ms = mt.device_ms(model)
            ref = getattr(on_cpu, method)(*(a[:m] for a in args))
            err = float(np.abs(got[:m] - ref).max())
            log(
                f"[10b] {model}: the leading {k} of {n} precursors, wall {wall:.4f} s ({k / wall:.1f} precursors/s), "
                f"device {dev_ms:.4f} ms ({k / max(dev_ms, 1e-9) * 1e3:.1f} precursors/s on the card; "
                f"{len(mt.events.get(model, []))} batches of {FinetuneManager.PREDICT_BATCH}); the card against the CPU on the "
                f"first {m}: max abs {err:.3g} {'ok' if err <= LF_PREDICTION_ATOL else 'FAILED'} ({name}, {card})"
            )
            if err > LF_PREDICTION_ATOL or got.shape[0] != k or not np.isfinite(got).all():
                raise AssertionError(f"proteome: the {model} model on the card departs from the CPU")
            del got
    log(f"[10b] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB over the four models ({name}, {card})")

    # SimplePrediction.forward (models, fragment m/z, the MS2 scatter): a
    # leading share first, then the whole digest if its rate fits the aim
    share = min(n, PROTEOME_FORWARD_PROBE)
    t0 = time.perf_counter()
    lib = SimplePrediction()(SpecLibBase(take(df, slice(0, share))))
    probe_s = time.perf_counter() - t0
    left = PROTEOME_BUDGET_S - (time.perf_counter() - t_phase)
    whole_s = probe_s * n / share
    if share < n and whole_s <= left:
        share = n
    elif share < n:
        share = max(share, int(share * left / probe_s) // PROTEOME_FORWARD_PROBE * PROTEOME_FORWARD_PROBE)
        log(
            f"[10b] cut: SimplePrediction.forward runs on the leading {share} of {n} precursors: at the probe's "
            f"{share and PROTEOME_FORWARD_PROBE / probe_s:.1f} precursors/s its host stages (encoding three times, "
            f"fragment m/z a precursor at a time in Python, the scatter) would take ~{whole_s:.0f} s over the whole "
            f"digest, {left:.0f} s of the phase's {PROTEOME_BUDGET_S:.0f} s are left"
        )
    if share > PROTEOME_FORWARD_PROBE:
        del lib
        t0 = time.perf_counter()
        lib = SimplePrediction()(SpecLibBase(take(df, slice(0, share))))
        probe_s = time.perf_counter() - t0
    log(
        f"[10b] SimplePrediction.forward on {share} precursors: {probe_s:.4f} s ({share / probe_s:.1f} precursors/s), "
        f"{lib.fragment_mz.shape[0]} fragment rows x {lib.fragment_mz.shape[1]} columns; phase {time.perf_counter() - t_phase:.1f} s "
        f"({name}, {card})"
    )
    if not (np.isfinite(lib.fragment_intensity).all() and lib.fragment_intensity.max() > 0):
        raise AssertionError("proteome: SimplePrediction.forward gave no finite intensities")


# ---------------------------------------------------------------------------
# phase [11], Bruker .d input. (a) The committed fixture of the port's zstd
# decoder (tests/torch_tdf_fixture.py: a small 4D world from sequences as a
# .d of the JAX package's writer, zstd level 3, and its frame payloads again
# at levels -5, 1 and 19 with and without checksum and content size): the
# port's read against the sha256 the JAX reader's arrays gave, each payload
# against its sha256, then the decoder's rate. (b) The full 4D world from
# sequences written as a .d by the port's writer and read back: equal to
# the input quantized through the converters. (c) `alphadia-torch -f
# run_4d.d -l lib.tsv` on phase [8]'s 4D quarter world (the .d of the
# port's writer, phase [8]'s TSV library, calibration batch 2,000, random
# state 0). The JAX package's CLI on the CPU on the same files (sha256
# below) at random states 0 to 5 (`PYTHONPATH=.:tests python
# tests/test_torch_bruker_tdf.py --random-state N`; JAX reads the port's
# raw-block frames through python-zstandard) read the values below. Six
# states, not three: at ~4,600 accepted targets the false share's binomial
# spread is ~0.0027, and states 3-5 read up to 0.0389 where 0-2 read at
# most 0.0360. The port's readings of the same files are draws from the
# same spread, not a pair with JAX's at each state (the two part at the
# third calibration step): with the final RT tolerance above 200 s, the
# false share's mean and standard deviation are 0.0382 and 0.0046 for
# JAX at states 1-11, 0.0385 and 0.0049 for the port on the CPU at 0-5
# (`... --packages port`), 0.0379 and 0.0048 for the port on the card at
# 0-11 (`tests/torch_search_step_readings.py --bruker`); single states
# read 0.0328-0.0455 (JAX) and 0.0271-0.0463 (the port). Gates, as phase
# [8]: identified at least the least less 0.005; false at most 0.02 or the
# largest + 0.005; the final RT tolerance
# at most 1.25 times the largest and below its 449.25 s start; the protein
# groups within 2% of JAX's band; the median error of the accepted
# targets' observed mobility against the generator's truth below 0.03
# (tests/e2e/test_bruker_d_e2e.py)
D_JAX_READINGS = {  # random states 0 to 5
    "identified": [0.9831144465290806, 0.8562851782363977, 0.8544090056285178, 0.8574108818011257,
                   0.8557223264540338, 0.8538461538461538],
    "false": [0.02279577995478523, 0.03595408273770847, 0.03282608695652174, 0.038876889848812095,
              0.03682842287694974, 0.034490238611713665],
    "rt_error": [123.88912558007439, 306.4576632167969, 273.10391532830306, 250.53903555550676,
                 274.19247067345026, 289.31461752274583],
    "protein_groups": [50, 50, 50, 50, 50, 50],
    "mobility_error_median": [0.024719327688217163, 0.0246046781539917, 0.024573445320129395, 0.024640440940856934,
                              0.02463376522064209, 0.024583548307418823],
}
D_SHA256 = "33a5eb4bfdd272d3a6a73d16d7a9746b965b36d09c0c7f8b1a35c6dbbfd4364e"
D_LIB_SHA256 = "ae80e2380c98c428219c9d3f38abdbbcb58e9e9bf496172df7fe5d83a6b997a5"
D_REL_BAND = 0.02
D_MOBILITY_ERROR_MAX = 0.03
D_RT_START = 449.25
DECODE_BYTES = 256 * 2**20  # decoded by each timed run of phase [11a]


def reader_times():
    """Host seconds of the Bruker reader's parts: SQLite, the zstd batch
    decode, the frames' decode (the zstd batch included), the window split."""
    from alphadia_torch.rawdata import bruker_tdf

    return MethodTimes([
        (bruker_tdf, "read_bruker_d", "reader"), (bruker_tdf, "_tables", "sqlite"),
        (bruker_tdf, "_decode_frames", "decode"), (bruker_tdf.zstd, "decompress_frames", "zstd"),
        (bruker_tdf, "_spectra", "split"),
    ])


def reader_split(s) -> str:
    return (
        f"SQLite {s['sqlite']:.4f} s, zstd batch {s['zstd']:.4f} s, frame blobs {s['decode'] - s['zstd']:.4f} s, "
        f"window split {s['split']:.4f} s"
    )


def phase11a(root, name, card):
    """The decoder built on the card's host and held to the fixture; its
    rate on the fixture's frames, on 1 and on every host thread."""
    import hashlib

    from alphadia_torch.rawdata import zstd
    from alphadia_torch.rawdata.bruker_tdf import read_bruker_d

    sys.path.insert(0, str(root / "tests"))
    from torch_tdf_fixture import DATA, array_sha256

    t0 = time.perf_counter()
    lib = zstd.build()
    log(f"[11a] built {lib.relative_to(root)} ({' '.join(zstd.CXX_FLAGS)}) in {time.perf_counter() - t0:.2f} s")
    rec = json.loads((DATA / "tdf_fixture.json").read_text())
    t0 = time.perf_counter()
    data = read_bruker_d(DATA / "tdf_world.d")
    t_read = time.perf_counter() - t0
    same = array_sha256(data) == rec["read_bruker_d_sha256"]
    log(
        f"[11a] fixture tdf_world.d: {data.n_spectra} spectra, {len(data.mz)} peaks, read in {t_read:.4f} s; the "
        f"sha256 of every array equal to the JAX reader's: {same}"
    )
    if not same:
        raise AssertionError("the fixture .d reads otherwise than the JAX package's reader read it")
    frames = rec["frames"]
    buf = np.fromfile(DATA / "zstd_frames.bin", np.uint8)
    args = (buf, frames["offset"], frames["length"], frames["size"])
    out = zstd.decompress_frames(*args, 1)
    ends = np.cumsum(frames["size"])
    good = [hashlib.sha256(out[e - n : e].tobytes()).hexdigest() for e, n in zip(ends, frames["size"])] == frames["sha256"]
    n_in, n_out = int(np.sum(frames["length"])), int(ends[-1])
    log(
        f"[11a] zstd_frames.bin: {len(frames['size'])} frames (levels {sorted(set(frames['level']))}, largest "
        f"{max(frames['size'])} B), {n_in} B in, {n_out} B out; every payload's sha256 equal: {good}"
    )
    if not good:
        raise AssertionError("the decoder's output differs from the fixture's payloads")
    reps = -(-DECODE_BYTES // n_out)
    threads = os.cpu_count() or 1
    for t in sorted({1, threads}):
        if not np.array_equal(zstd.decompress_frames(*args, t), out):
            raise AssertionError(f"the decoder on {t} threads gives other bytes")
        t0 = time.perf_counter()
        for _ in range(reps):
            zstd.decompress_frames(*args, t)
        dt = time.perf_counter() - t0
        log(
            f"[11a] decode {reps} x the fixture's frames on {t} thread(s): {dt:.4f} s, "
            f"{reps * n_in / dt / 1e6:.1f} MB/s in, {reps * n_out / dt / 1e6:.1f} MB/s out, "
            f"{reps * len(frames['size']) / dt:.0f} frames/s (host of {name}, {card})"
        )


def phase11b(root, name, card, tmp, spectra):
    """The full 4D world from sequences (made in phase [8]) through the
    port's TDF writer and reader: the read equals the input quantized to
    tof index and scan."""
    from alphadia_torch.rawdata import bruker_tdf
    from alphadia_torch.testing.tdf_writer import spectrum_data_to_tdf

    sys.path.insert(0, str(root / "tests"))
    from torch_workflow_worlds import same_spectra, tdf_quantized

    log(f"[11b] 4D full world from sequences (made in phase [8]): {len(spectra.mz)} peaks")
    d_path = tmp / "run_4d_full.d"
    t0 = time.perf_counter()
    spectrum_data_to_tdf(spectra, d_path)
    t_write = time.perf_counter() - t0
    size = sum(p.stat().st_size for p in d_path.iterdir())
    with reader_times() as rt:
        back = bruker_tdf.read_bruker_d(d_path, thread_count=os.cpu_count() or 1)
    s = rt.seconds
    expected, worst_ppm, worst_im, outside = tdf_quantized(spectra)
    same = same_spectra(back, expected)
    n_frames = spectra.n_spectra  # one frame a spectrum
    log(
        f"[11b] written in {t_write:.4f} s: {size / 2**20:.1f} MiB ({size / len(spectra.mz):.2f} B a peak); read in "
        f"{s['reader']:.4f} s ({reader_split(s)}): {size / s['reader'] / 2**20:.1f} MiB/s, "
        f"{n_frames / s['reader']:.0f} frames/s, {len(back.mz) / s['reader']:.0f} peaks/s (host of {name}, {card})"
    )
    log(
        f"[11b] read back {len(back.mz)} peaks of {len(spectra.mz)} (cells merged {len(spectra.mz) - len(back.mz)}); "
        f"equal bit for bit to the input quantized through the converters: {same}; worst m/z error {worst_ppm:.4f} "
        f"ppm, worst 1/K0 error {worst_im:.6f} of the peaks on the scan grid ({outside} off it, clipped to the edge scans)"
    )
    if not same:
        raise AssertionError("the .d read back is not the input quantized to tof index and scan")


def phase11c(root, name, card, launches, secs, tmp):
    """``alphadia-torch -f run_4d.d -l lib.tsv`` on the card: the walls (the
    reader split, the library build, the search step, the outputs), the
    kernel's launches (each pass's first launch of every step held against
    the plain version, every launch timed again alone) and the gates above."""
    import hashlib

    import torch

    import alphadia_torch.cli as cli
    import alphadia_torch.search_step as search_step
    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.outputs.search_plan_output import SearchPlanOutput
    from alphadia_torch.workflow.peptidecentric.optimization_handler import OptimizationHandler

    sys.path.insert(0, str(root / "tests"))
    from torch_workflow_worlds import D_BATCH, D_WORLD, d_readings, d_sha256, write_d_inputs

    d = tmp / "bruker_search"
    d.mkdir()
    t0 = time.perf_counter()
    d_path, lib_path, truth, cycle_rt, spectra = write_d_inputs(d)
    sha = (d_sha256(d_path), hashlib.sha256(lib_path.read_bytes()).hexdigest())
    log(
        f"[11c] inputs: {D_WORLD['n_peptides']} peptides, {D_WORLD['n_windows']} windows, {len(spectra.mz)} peaks as "
        f"{d_path.name} ({sum(p.stat().st_size for p in d_path.iterdir()) / 2**20:.1f} MiB, sha256 {sha[0]}), "
        f"{lib_path.name} sha256 {sha[1]}; made in {time.perf_counter() - t0:.2f} s"
    )
    if sha != (D_SHA256, D_LIB_SHA256):
        raise AssertionError("the .d search's inputs are not the files of the JAX readings")
    del spectra

    captured = {}
    workflow_cls = search_step.PeptideCentricWorkflow
    process_batch = OptimizationHandler._process_batch

    class Captured(workflow_cls):
        def load(self, *a, **k):
            rec.stage = "load"
            captured["wf"] = self
            return super().load(*a, **k)

        def extraction(self):
            rec.stage = "extraction"
            return super().extraction()

    def staged(handler):
        rec.stage = f"step{len(handler.step_log)}"
        return process_batch(handler)

    out = tmp / "bruker_search_out"
    argv = ["-o", str(out), "-f", str(d_path), "-l", str(lib_path), "--config-dict", json.dumps({
        "general": {"random_state": WF_RANDOM_STATE, "log_level": "PROGRESS"}, "calibration": {"batch_size": D_BATCH},
    })]
    timed = MethodTimes([
        (search_step.SearchStep, "load_library", "library"), (search_step.SearchStep, "_process_raw_file", "step"),
        (SearchPlanOutput, "build", "outputs"),
    ])
    search_step.PeptideCentricWorkflow = Captured
    OptimizationHandler._process_batch = staged
    code = 0
    try:
        with Recorder() as rec, timed as mt, reader_times() as rt:
            torch.cuda.synchronize()
            xic_cuda.launches = 0
            t0 = time.perf_counter()
            try:
                cli.run(argv)
            except SystemExit as e:
                code = e.code
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_launch = xic_cuda.launches
    finally:
        search_step.PeptideCentricWorkflow = workflow_cls
        OptimizationHandler._process_batch = process_batch
    log(f"[11c] alphadia-torch {' '.join(a if len(a) < 60 else '...' for a in argv)}: exit {code}, wall {wall:.4f} s")
    if code != 0:
        raise AssertionError(f"the CLI from a .d exited {code}")
    if n_launch != len(rec.calls) or n_launch == 0:
        raise AssertionError(f".d search: {n_launch} kernel launches counted, {len(rec.calls)} wrapper calls recorded")
    if not all(variant(kw) == "c_scan_window" for _, _, kw in rec.calls):
        raise AssertionError(".d search: a launch without the scan window (the run is not on the 4D path)")
    wf = captured["wf"]
    timings = {k: v.get("duration", float("nan")) for k, v in wf.timing_manager.timings.items()}
    m, r = mt.seconds, rt.seconds
    log(
        f"[11c] walls: library build {m['library']:.4f} s; search step {m['step']:.4f} s: workflow load "
        f"{timings['load']:.4f} s (of which the .d reader {r['reader']:.4f} s: {reader_split(r)}), optimization "
        f"{timings['optimization']:.4f} s ({len(wf.optimization_handler.step_log)} steps), extraction "
        f"{timings['extraction']:.4f} s; outputs {m['outputs']:.4f} s ({name}, {card})"
    )

    calls = rec.calls
    launches["bruker_search"] = n_launch
    secs["bruker_search"] = wall
    worst = launches_against_plain("[11c]", "run_4d", calls)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    per_pass = summed_device_ms(calls, flush)
    del flush
    for (stage, pass_name), acc in sorted(per_pass.items()):
        log(
            f"[11c] kernel, {stage} {pass_name}: {acc['launches']} launches, {acc['ms']:.4f} ms warm "
            f"({acc['bound_ms'] / acc['ms']:.2f} of bound), L2 flushed {acc['flushed_ms']:.4f} ms, bound "
            f"{acc['bound_ms']:.4f} ms ({acc['bytes'] / 1e6:.2f} MB) ({name}, {card})"
        )
    kernel_ms = sum(x["ms"] for x in per_pass.values())
    log(
        f"[11c] kernel: {n_launch} launches (variant c, scan window), summed {kernel_ms:.4f} ms warm, bound "
        f"{sum(x['bound_ms'] for x in per_pass.values()):.4f} ms; {kernel_ms / (wall * 1e3):.5f} of the CLI's wall "
        f"({name}, {card})"
    )

    got = d_readings(out, truth, cycle_rt)
    log(f"[11c] readings: {json.dumps(got)}")
    jax = D_JAX_READINGS
    checks = [
        ("identified", got["identified"], (min(jax["identified"]) - 0.005, 1.0)),
        ("false", got["false"], (0.0, max(0.02, max(jax["false"]) + 0.005))),
        ("rt_error", got["rt_error"], (0.0, min(1.25 * max(jax["rt_error"]), D_RT_START - 1e-6))),
        ("protein_groups", got["protein_groups"], band(jax["protein_groups"], rel=D_REL_BAND)),
        ("mobility_error_median", got["mobility_error_median"], (0.0, D_MOBILITY_ERROR_MAX)),
    ]
    failed = []
    for k, v, (lo, hi) in checks:
        ok = lo <= v <= hi
        log(f"[11c] gate {k}: {v:.4f} in [{lo:.4f}, {hi:.4f}] {'ok' if ok else 'FAILED'} ({name}, {card})")
        if not ok:
            failed.append(k)
    if failed:
        raise AssertionError(f".d search: gates failed: {failed}")
    return worst

# ---------------------------------------------------------------------------
# 12. HDF: the committed fixture, a run's and a library's size, the MBR plan
# ---------------------------------------------------------------------------
# phase [12b]: an hour-long Orbitrap DIA run holds tens to hundreds of
# millions of centroided peaks; a predicted human library ~1 million
# precursors of 12 fragments. Both are cut (and the cut printed) where a
# probe's rates say the phase would pass its aim (30 s until phase [17]
# took its share of the script's time)
HDF_RUN_PEAKS = 50_000_000
HDF_LIB_PRECURSORS = 1_000_000
HDF_LIB_FRAGMENTS = 12
HDF_BUDGET_S = 15.0
# phase [12c]: the MBR plan (library step -> speclib.mbr.hdf -> MBR step)
# through alphadia-torch on phase [9]'s two runs written as alphaRaw .hdf by
# the port's writer (tests/torch_workflow_worlds.write_cli_inputs(...,
# raw_format="hdf")), with save_library and save_flat_library on, random
# state 0. The inputs are held by the sha256 of their decoded arrays (zlib's
# bytes may differ between machines). The JAX package's CLI with the MBR
# step on the same files read, on the CPU, at random states 0 to 5
# (`PYTHONPATH=.:tests python tests/test_torch_mbr.py --random-state 0 1 2
# 3 4 5`), the readings below: states 3-5 left the band of states 0-2 (the
# MBR library 1,312-1,335 precursors against 1,318; false on run_1 up to
# 0.0456 against 0.0416), so the gates take all six, as phase [11c] does.
# Gates, as phase [9]: identified at least the least less 0.005, false at
# most 0.02 or the largest + 0.005; the protein groups and the MBR
# library's precursors within 2% of JAX's band
MBR_INPUT_SHA256 = [
    "ca8b6ed99740f92a93be1d17c557cb7c4d285af3e7dc5776e084541ae0e5478d",
    "9a7ec600b3b2cae08717623186b7d35bda014cca79b2d40d9f56e76ab7b5ec90",
]
MBR_JAX_READINGS = {  # random states 0 to 5
    "identified_run_0": [0.9984114376489277, 0.9992057188244639, 1.0, 0.9992057188244639, 1.0, 0.9992057188244639],
    "false_run_0": [0.0485362095531587, 0.052428681572860444, 0.04984662576687116, 0.04973221117061974,
                    0.04284621270084162, 0.04573643410852713],
    "identified_run_1": [0.9992057188244639, 0.9992057188244639, 0.9992057188244639, 1.0, 0.9992057188244639,
                         0.9992057188244639],
    "false_run_1": [0.03557617942768755, 0.04160246533127889, 0.03554868624420402, 0.0362095531587057,
                    0.040769230769230766, 0.04559505409582689],
    "protein_groups": [519, 520, 518, 519, 519, 523],
    "mbr_library_precursors": [1318, 1318, 1318, 1328, 1335, 1312],
}
MBR_REL_BAND = 0.02


def phase12a(root, name, card, tmp):
    """The committed fixture (h5py's files) read by the port with the sha256
    and attributes of h5py's reading; each written again by the port's
    writer and read back the same."""
    sys.path.insert(0, str(root / "tests"))
    from torch_hdf_fixture import DATA, FILES, file_record, rewritten

    record = json.loads((DATA / "hdf_fixture.json").read_text())
    threads = os.cpu_count() or 1
    for fname in FILES:
        t0 = time.perf_counter()
        got = file_record(DATA / fname)
        t_read = time.perf_counter() - t0
        out = tmp / fname
        t0 = time.perf_counter()
        rewritten(DATA / fname, out, threads=threads)
        t_write = time.perf_counter() - t0
        again = file_record(out)
        size = out.stat().st_size
        out.unlink()
        want = record["files"][fname]
        log(
            f"[12a] {fname}: {len(want['datasets'])} datasets, {(DATA / fname).stat().st_size} B; read in {t_read:.4f} s "
            f"with h5py's sha256 and attributes: {got == want}; written again in {t_write:.4f} s ({size} B) and read "
            f"back the same: {again == want} (host of {name}, {card})"
        )
        if got != want or again != want:
            raise AssertionError(f"the HDF fixture {fname} reads otherwise than h5py read it")


def tiled_run(spectra, n_peaks):
    """``spectra`` repeated in RT (each copy after the last, one cycle
    apart) until ``n_peaks`` peaks, the last copy cut at a spectrum."""
    from alphadia_torch.rawdata.source import SpectrumData

    per = len(spectra.mz)
    copies = -(-n_peaks // per)
    span = float(spectra.rt[-1] - spectra.rt[0]) + float(np.median(np.diff(spectra.rt))) * 4
    counts = spectra.peak_stop_idx - spectra.peak_start_idx
    stop = np.cumsum(np.tile(counts, copies))
    keep = int(np.searchsorted(stop, n_peaks, side="right")) or 1
    n = int(stop[keep - 1])
    start = np.concatenate([[0], stop[: keep - 1]]).astype(np.int64)
    rt = (np.tile(spectra.rt.astype(np.float64), copies) + np.repeat(np.arange(copies) * span, spectra.n_spectra))[:keep]
    return SpectrumData(
        rt=rt.astype(np.float32), ms_level=np.tile(spectra.ms_level, copies)[:keep],
        isolation_lower_mz=np.tile(spectra.isolation_lower_mz, copies)[:keep],
        isolation_upper_mz=np.tile(spectra.isolation_upper_mz, copies)[:keep],
        peak_start_idx=start, peak_stop_idx=stop[:keep].astype(np.int64),
        mz=np.tile(spectra.mz, copies)[:n], intensity=np.tile(spectra.intensity, copies)[:n],
    )


def seeded_flat_library(n_prec, n_frag, seed=12):
    """A flat library of ``n_prec`` precursors of ``n_frag`` fragments with
    the search's columns (text as object arrays, as the port's loaders give)."""
    from alphadia_torch.library.speclib import SpecLibFlat

    rng = np.random.default_rng(seed)
    lens = rng.integers(7, 26, n_prec)
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    raw = letters[rng.integers(0, 20, (n_prec, 25))]
    raw[np.arange(25)[None, :] >= lens[:, None]] = 0
    seqs = raw.view("S25").ravel().astype(str).astype(object)
    prot = np.char.add("P", rng.integers(10000, 99999, n_prec).astype(str)).astype(object)
    n_f = n_prec * n_frag
    prec = {
        "sequence": seqs, "proteins": prot,
        "mods": np.where(rng.random(n_prec) < 0.2, "Oxidation@M", "").astype(object),
        "charge": rng.integers(1, 5, n_prec).astype(np.uint8),
        "mz_library": rng.uniform(400, 1200, n_prec).astype(np.float32),
        "rt_library": rng.uniform(0, 3600, n_prec).astype(np.float32),
        "decoy": (np.arange(n_prec) % 2).astype(np.uint8),
        "elution_group_idx": (np.arange(n_prec) // 2).astype(np.uint32),
        "precursor_idx": np.arange(n_prec, dtype=np.uint32),
        "mod_seq_charge_hash": rng.integers(0, 2**63 - 1, n_prec).astype(np.int64),
        "flat_frag_start_idx": (np.arange(n_prec) * n_frag).astype(np.uint32),
        "flat_frag_stop_idx": (np.arange(1, n_prec + 1) * n_frag).astype(np.uint32),
        "is_shared": rng.random(n_prec) < 0.1,
    }
    frag = {
        "mz_library": rng.uniform(150, 1800, n_f).astype(np.float32),
        "intensity": rng.random(n_f).astype(np.float32),
        "cardinality": np.ones(n_f, np.uint8), "type": rng.choice(np.array([98, 121], np.uint8), n_f),
        "loss_type": np.zeros(n_f, np.uint8), "charge": rng.integers(1, 3, n_f).astype(np.uint8),
        "number": rng.integers(1, 20, n_f).astype(np.uint8), "position": rng.integers(0, 20, n_f).astype(np.uint8),
    }
    return SpecLibFlat(prec, frag)


def phase12b(root, name, card, tmp):
    """An alphaRaw ``.hdf`` of a run's size and a flat library's, each
    written by the port and read back equal, on 1 and on every host thread."""
    from alphadia_torch.library.speclib import SpecLibFlat
    from alphadia_torch.rawdata.hdf import read_alpharaw_hdf
    from alphadia_torch.testing.alpharaw_writer import save_alpharaw_hdf

    sys.path.insert(0, str(root / "tests"))
    from torch_workflow_worlds import same_spectra

    threads = os.cpu_count() or 1
    t_phase = time.perf_counter()
    base, _, _ = make_spectra(N_PEPTIDES, N_CYCLES)
    # probe: a twentieth of each size written and read on one thread, to
    # size the phase to its aim
    probe = tiled_run(base, HDF_RUN_PEAKS // 20)
    t0 = time.perf_counter()
    save_alpharaw_hdf(tmp / "probe.hdf", probe)
    read_alpharaw_hdf(tmp / "probe.hdf")
    run_rate = len(probe.mz) / (time.perf_counter() - t0)
    lib = seeded_flat_library(HDF_LIB_PRECURSORS // 20, HDF_LIB_FRAGMENTS)
    t0 = time.perf_counter()
    lib.save_hdf(tmp / "probe_lib.hdf")
    SpecLibFlat.load_hdf(tmp / "probe_lib.hdf")
    lib_rate = (HDF_LIB_PRECURSORS // 20) / (time.perf_counter() - t0)
    # each size is written and read on one thread and again on N, then
    # made and compared: ~2.5 single-thread passes
    predicted = 2.5 * (HDF_RUN_PEAKS / run_rate + HDF_LIB_PRECURSORS / lib_rate)
    cut = min(1.0, HDF_BUDGET_S / predicted)
    n_peaks, n_prec = int(HDF_RUN_PEAKS * cut), int(HDF_LIB_PRECURSORS * cut)
    log(
        f"[12b] probe: {run_rate:.0f} peaks/s and {lib_rate:.0f} precursors/s written and read on one thread; "
        f"predicted {predicted:.1f} s at full size against the {HDF_BUDGET_S:.0f} s aim: "
        + (f"sizes cut to {cut:.3f}: {n_peaks} peaks, {n_prec} precursors" if cut < 1 else "full size")
    )
    del probe, lib
    (tmp / "probe.hdf").unlink()
    (tmp / "probe_lib.hdf").unlink()

    run = tiled_run(base, n_peaks)
    del base
    raw_bytes = sum(getattr(run, f).nbytes for f in ("rt", "ms_level", "isolation_lower_mz", "isolation_upper_mz",
                                                     "peak_start_idx", "peak_stop_idx", "mz", "intensity"))
    lib = seeded_flat_library(n_prec, HDF_LIB_FRAGMENTS)
    # text columns counted as the fixed-length strings written
    lib_bytes = sum((v.astype("S") if v.dtype == object else v).nbytes
                    for frame in (lib.precursor_df, lib.fragment_df) for v in frame.values())
    for t in sorted({1, threads}):
        path = tmp / f"run_{t}.hdf"
        t0 = time.perf_counter()
        save_alpharaw_hdf(path, run, thread_count=t)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = read_alpharaw_hdf(path, thread_count=t)
        t_read = time.perf_counter() - t0
        size = path.stat().st_size
        equal = same_spectra(back, run)
        del back
        log(
            f"[12b] alphaRaw .hdf of {len(run.mz)} peaks, {run.n_spectra} spectra ({raw_bytes / 1e6:.1f} MB of arrays, "
            f"{size / 1e6:.1f} MB on disk) on {t} thread(s): written in {t_write:.4f} s ({raw_bytes / t_write / 1e6:.1f} "
            f"MB/s, {len(run.mz) / t_write:.0f} peaks/s), read in {t_read:.4f} s ({raw_bytes / t_read / 1e6:.1f} MB/s, "
            f"{len(run.mz) / t_read:.0f} peaks/s); read back equal: {equal} (host of {name}, {card})"
        )
        if not equal:
            raise AssertionError("the run's .hdf reads back otherwise than it was written")
        if t != threads:
            path.unlink()
        path = tmp / f"lib_{t}.hdf"
        t0 = time.perf_counter()
        lib.save_hdf(path, thread_count=t)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = SpecLibFlat.load_hdf(path, thread_count=t)
        t_read = time.perf_counter() - t0
        size = path.stat().st_size
        equal = same_frame(back.precursor_df, lib.precursor_df) and same_frame(back.fragment_df, lib.fragment_df)
        del back
        path.unlink()
        n_rows = n_prec * (1 + HDF_LIB_FRAGMENTS)
        log(
            f"[12b] flat library of {n_prec} precursors x {HDF_LIB_FRAGMENTS} fragments ({lib_bytes / 1e6:.1f} MB of "
            f"arrays, {size / 1e6:.1f} MB on disk) on {t} thread(s): written in {t_write:.4f} s ({lib_bytes / t_write / 1e6:.1f} "
            f"MB/s, {n_rows / t_write:.0f} rows/s), read in {t_read:.4f} s ({lib_bytes / t_read / 1e6:.1f} MB/s, "
            f"{n_rows / t_read:.0f} rows/s); read back equal: {equal} (host of {name}, {card})"
        )
        if not equal:
            raise AssertionError("the library's .hdf reads back otherwise than it was written")
    (tmp / f"run_{threads}.hdf").unlink()
    log(f"[12b] phase wall {time.perf_counter() - t_phase:.2f} s (aim {HDF_BUDGET_S:.0f} s)")


def phase12c(root, name, card, launches, secs, tmp):
    """``alphadia-torch`` with the MBR step on two alphaRaw ``.hdf`` runs:
    the walls of each step and its outputs, the kernel's launches per step
    (each pass's first launch of every step held against the plain
    version, every launch timed again alone), the saved libraries read back
    equal to the frames in memory, and the gates above."""
    import torch

    import alphadia_torch.cli as cli
    import alphadia_torch.search_step as search_step
    from alphadia_torch.library.loader import load_speclib_hdf
    from alphadia_torch.library.speclib import SpecLibBase, SpecLibFlat
    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.outputs.search_plan_output import SearchPlanOutput
    from alphadia_torch.rawdata.hdf import read_alpharaw_hdf
    from alphadia_torch.workflow.peptidecentric.optimization_handler import OptimizationHandler

    sys.path.insert(0, str(root / "tests"))
    from torch_workflow_worlds import CLI_WORLD, cli_readings, spectra_sha256, write_cli_inputs

    t0 = time.perf_counter()
    (tmp / "mbr_inputs").mkdir()
    raws, lib, truth, cycle_rts = write_cli_inputs(tmp / "mbr_inputs", CLI_WORLD, raw_format="hdf")
    sha = [spectra_sha256(read_alpharaw_hdf(r)) for r in raws]
    log(
        f"[12c] inputs: {len(raws)} runs of {CLI_WORLD['n_peptides']} peptides as alphaRaw .hdf "
        f"({sum(r.stat().st_size for r in raws) / 2**20:.1f} MiB), the TSV library of phase [9]; sha256 of the decoded "
        f"arrays {sha}; made in {time.perf_counter() - t0:.2f} s"
    )
    if sha != MBR_INPUT_SHA256:
        raise AssertionError("the MBR plan's inputs are not the arrays of the JAX readings")

    steps, saved = [], {}
    run = search_step.SearchStep.run
    build = SearchPlanOutput.build
    base_save, flat_save = SpecLibBase.save_hdf, SpecLibFlat.save_hdf
    workflow_cls = search_step.PeptideCentricWorkflow
    process_batch = OptimizationHandler._process_batch

    class Captured(workflow_cls):
        def load(self, *a, **k):
            rec.stage = "load"
            return super().load(*a, **k)

        def extraction(self):
            rec.stage = "extraction"
            return super().extraction()

    def staged(handler):
        rec.stage = f"step{len(handler.step_log)}"
        return process_batch(handler)

    def timed_run(self):
        entry = {"dir": Path(self.output_folder).name, "first_call": len(rec.calls)}
        steps.append(entry)
        t = time.perf_counter()
        try:
            return run(self)
        finally:
            torch.cuda.synchronize()
            entry["wall"] = time.perf_counter() - t
            entry["calls"] = len(rec.calls) - entry["first_call"]

    def timed_build(self, *a, **k):
        t = time.perf_counter()
        try:
            return build(self, *a, **k)
        finally:
            steps[-1]["outputs"] = time.perf_counter() - t

    def kept(save):
        def keep(self, path, *a, **k):
            saved[Path(path).relative_to(out).as_posix()] = self
            return save(self, path, *a, **k)

        return keep

    out = tmp / "mbr_out"
    argv = ["-o", str(out), "-f", str(raws[0]), "-f", str(raws[1]), "-l", str(lib), "--config-dict", json.dumps({
        "general": {"random_state": 0, "log_level": "PROGRESS", "mbr_step_enabled": True, "save_library": True,
                    "save_flat_library": True}})]
    search_step.PeptideCentricWorkflow = Captured
    OptimizationHandler._process_batch = staged
    search_step.SearchStep.run = timed_run
    SearchPlanOutput.build = timed_build
    SpecLibBase.save_hdf, SpecLibFlat.save_hdf = kept(base_save), kept(flat_save)
    code = 0
    try:
        with Recorder() as rec:
            torch.cuda.synchronize()
            xic_cuda.launches = 0
            t0 = time.perf_counter()
            try:
                cli.run(argv)
            except SystemExit as e:
                code = e.code
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_launch = xic_cuda.launches
    finally:
        search_step.PeptideCentricWorkflow = workflow_cls
        OptimizationHandler._process_batch = process_batch
        search_step.SearchStep.run = run
        SearchPlanOutput.build = build
        SpecLibBase.save_hdf, SpecLibFlat.save_hdf = base_save, flat_save
    log(f"[12c] alphadia-torch {' '.join(a if len(a) < 60 else '...' for a in argv)}: exit {code}, wall {wall:.4f} s")
    if code != 0:
        raise AssertionError(f"the MBR plan exited {code}")
    if n_launch != len(rec.calls) or n_launch == 0:
        raise AssertionError(f"MBR plan: {n_launch} kernel launches counted, {len(rec.calls)} wrapper calls recorded")
    if [s_["dir"] for s_ in steps] != ["library", out.name]:
        raise AssertionError(f"MBR plan: steps ran in {[s_['dir'] for s_ in steps]}")

    mbr_lib = load_speclib_hdf(out / "library" / "speclib.mbr.hdf")
    n_mbr = len(mbr_lib.precursor_df["precursor_idx"])
    worst = [0.0, 0.0]
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    for label, entry in zip(("library_step", "mbr_step"), steps):
        calls = rec.calls[entry["first_call"] : entry["first_call"] + entry["calls"]]
        launches[f"mbr_plan_{label}"] = len(calls)
        secs[f"mbr_plan_{label}"] = entry["wall"]
        w = launches_against_plain("[12c]", label, calls)
        worst = [max(worst[0], w[0]), max(worst[1], w[1])]
        per_pass = summed_device_ms(calls, flush)
        for (stage, pass_name), acc in sorted(per_pass.items()):
            log(
                f"[12c] {label} kernel, {stage} {pass_name}: {acc['launches']} launches, {acc['ms']:.4f} ms warm "
                f"({acc['bound_ms'] / acc['ms']:.2f} of bound), L2 flushed {acc['flushed_ms']:.4f} ms, bound "
                f"{acc['bound_ms']:.4f} ms ({acc['bytes'] / 1e6:.2f} MB) ({name}, {card})"
            )
        kernel_ms = sum(x["ms"] for x in per_pass.values())
        log(
            f"[12c] {label}: wall {entry['wall']:.4f} s (outputs {entry['outputs']:.4f} s); {len(calls)} kernel "
            f"launches, summed {kernel_ms:.4f} ms warm, bound {sum(x['bound_ms'] for x in per_pass.values()):.4f} ms, "
            f"{kernel_ms / (entry['wall'] * 1e3):.5f} of the step's wall ({name}, {card})"
        )
    del flush

    same = {}
    for rel, lib_mem in sorted(saved.items()):
        back = load_speclib_hdf(out / rel)
        if isinstance(lib_mem, SpecLibBase):
            same[rel] = (same_frame(back.precursor_df, lib_mem.precursor_df)
                         and back.charged_frag_types == lib_mem.charged_frag_types
                         and np.array_equal(back.fragment_mz, lib_mem.fragment_mz)
                         and np.array_equal(back.fragment_intensity, lib_mem.fragment_intensity))
        else:
            same[rel] = same_frame(back.precursor_df, lib_mem.precursor_df) and same_frame(back.fragment_df,
                                                                                        lib_mem.fragment_df)
    log(f"[12c] saved libraries read back equal to the frames in memory: {json.dumps(same)}; the MBR library "
        f"(library/speclib.mbr.hdf): {n_mbr} precursors")
    wanted = {"library/speclib.hdf", "library/speclib.flat.hdf", "library/speclib.mbr.hdf", "speclib.mbr.hdf"}
    if set(same) != wanted or not all(same.values()):
        raise AssertionError(f"MBR plan: the saved libraries {same} (wanted {sorted(wanted)})")

    got = cli_readings(out, truth, cycle_rts)
    got["mbr_library_precursors"] = n_mbr
    log(f"[12c] readings at the MBR step: {json.dumps(got)}")
    jax = MBR_JAX_READINGS
    checks = []
    for r in range(2):
        checks += [(f"identified_run_{r}", got[f"identified_run_{r}"], (min(jax[f"identified_run_{r}"]) - 0.005, 1.0)),
                   (f"false_run_{r}", got[f"false_run_{r}"], (0.0, max(0.02, max(jax[f"false_run_{r}"]) + 0.005)))]
    for k in ("protein_groups", "mbr_library_precursors"):
        checks.append((k, got[k], band(jax[k], rel=MBR_REL_BAND)))
    failed = []
    for k, v, (lo, hi) in checks:
        ok = lo <= v <= hi
        log(f"[12c] gate {k}: {v:.4f} in [{lo:.4f}, {hi:.4f}] {'ok' if ok else 'FAILED'} ({name}, {card})")
        if not ok:
            failed.append(k)
    if failed:
        raise AssertionError(f"MBR plan: gates failed: {failed}")
    return worst


# ---------------------------------------------------------------------------
# [13] requantification on the card
# ---------------------------------------------------------------------------
# phase [13a]: the dimethyl-multiplexed search of tests/e2e/
# test_multiplex_e2e.py at the library-free world's width
# (tests/torch_workflow_worlds.write_multiplex_inputs: channels 0, 4 and 12
# of the 20-protein FASTA's dimethyl digest, 0 and 4 planted, 4 at half
# intensity), through alphadia-torch with the e2e test's overrides at random
# state 0. The inputs are held by the sha256 of the run's decoded arrays and
# of the base library's decoded frames. The JAX package's CLI on the same
# files read, on the CPU, (`PYTHONPATH=.:tests python tests/
# torch_requant_readings.py --multiplex --random-state 0 1 ... 17`) the
# readings below. Gates: the e2e test's (channel 4 at least half of channel
# 0; channel 12 at most max(1, 0.05 x channel 0)), channel 4 at least the
# least of JAX's less 2%, channel 12 inside JAX's band over states 0-17
# widened by 2% (states 0-5 read 15-44; the port's shift below)
MP_INPUT_SHA256 = [
    "1b45733781a1af2c53ebdc022c1b3fe0673301aede24e68c7cae229b3175b352",
    "94bda9644c89c05cdacdbb09e5e33edc3c8d4514d30bc441f6690d2637444917",
]
MP_JAX_READINGS = {  # random states 0 to 17
    "channel_0": [1117, 1208, 1214, 1195, 1201, 1195, 1212, 1193, 1114, 1116, 1205, 1212, 1104, 1216, 1201, 1218, 1202,
                  1204],
    "channel_4": [1125, 1219, 1224, 1205, 1215, 1208, 1217, 1206, 1128, 1131, 1215, 1220, 1111, 1215, 1211, 1221, 1207,
                  1213],
    "channel_12": [15, 28, 39, 27, 44, 30, 25, 28, 42, 17, 40, 40, 17, 30, 61, 38, 47, 50],
}
MP_REL_BAND = 0.02
MP_RANDOM_STATE = 0
# the same search with tpu.gather_slab 2048, where no window overflows its
# slab: there the port's reading of an overflowing window (from the
# candidate's first cycle, ROADMAP §3: JAX's features depend on the window
# bucket) does not part the two packages, and the JAX CLI's readings at
# states 0-5 are the port's on the CPU within their spread (channel 12: 32,
# 54, 33, 30, 49, 52 against 26, 47, 53, 32, 50, 52), where at the default
# 256 the port's channel 12 reads 35-61 (mean 48.4) against JAX's 15-61
# (mean 34.3) over states 0-17; so every channel is gated on this band
# (`PYTHONPATH=.:tests python tests/torch_requant_readings.py --multiplex
# --gather-slab 2048 --random-state 0 1 2 3 4 5 --port`)
MP_WIDE_SLAB = 2048
MP_WIDE_SLAB_JAX_READINGS = {  # random states 0 to 5, tpu.gather_slab 2048
    "channel_0": [1126, 1197, 1126, 1227, 1191, 1194],
    "channel_4": [1127, 1206, 1120, 1218, 1195, 1211],
    "channel_12": [32, 54, 33, 30, 49, 52],
}
# phase [13b]: transfer_library.enabled through alphadia-torch on the two
# runs of the physics world (tests/torch_workflow_worlds.
# write_transfer_inputs: the 20-protein FASTA's digest with
# testing/physics.py's RT and MS2, every fragment planted) at the default
# config, random state 0; the inputs held by sha256 as [13a]'s. The JAX
# package's CLI on the same files (`PYTHONPATH=.:tests python tests/
# torch_requant_readings.py --transfer --random-state 0 1 2 3 4 5`) read the
# transfer library's size below (the gates: see TR_REL_BAND). On phase
# [9]'s runs the JAX CLI's transfer library is empty (`... --transfer
# --world cli`, state 0: all 2,595 PSMs fall to the MS2 QC; those runs plant
# a precursor's strongest fragments, a median of 10 of the 40 its b/y space
# holds, so the median correlation over the whole space is 0)
TR_INPUT_SHA256 = [
    "64410a860d54f8c8480008e0b3343a8430e9e867b056c984c581fa4c71ffd001",
    "7825b677dc6588a229cd076ac8730c5191bc980a5240d10f4cc69395a1948a42",
    "8c072e731bf95a1b2c28a2ccf58ef868f9b2251a0a8fecc225a22cb9fb03f805",
]
TR_JAX_READINGS = {  # random states 0 to 5
    "transfer_psms": [3452, 3455, 3458, 3460, 3465, 3451],
    "transfer_fragments": [193333, 193481, 193513, 193745, 193838, 193048],
    "transfer_precursors": [1934, 1967, 1973, 1966, 1931, 1970],
}
# The port's transfer library sits 2-3% above JAX's on these files (the CPU,
# states 0-5: PSMs 3,531-3,556 against 3,451-3,465; at tpu.gather_slab 2048,
# `... torch_requant_readings.py --transfer --gather-slab 2048`, the port's
# state 0 reads 3,195 against JAX's 3,034-3,228 at states 0-5), while both
# handlers give the same rows on the same PSMs and calibration (tests/
# test_torch_transfer.py): the shift comes from the search, whose windows
# overflow their slab in this world (ROADMAP §3). The gates take JAX's band
# widened by 5%
TR_REL_BAND = 0.05
TR_FRAGMENT_SPACE_MIN = 1.5  # the requant's fragments a precursor over the scored set's


def all_launches_against_plain(phase, label, calls):
    """Every recorded launch run again and held against the plain version;
    per pass (stage, selection or scoring): the launches, their B, Q, W and
    variants, the largest errors, the kernel's summed device ms (CUDA
    events, warm) and the bound (``work``); returns (largest (abs, rel),
    {pass: summary})."""
    from alphadia_torch.ops.xic_cuda import extract_xic_cuda

    worst, per_pass = [0.0, 0.0], {}
    for stage, args, kw in calls:
        res = compare(args, kw)
        B, Q = args[2].shape
        nbytes, ops = work(args, kw)
        a = per_pass.setdefault((stage, pass_of(kw)), dict(launches=0, B=set(), Q=set(), W=set(), variants=set(),
                                                         abs=0.0, rel=0.0, bad=0, ms=0.0, bytes=0, ops=0))
        a["launches"] += 1
        a["B"].add(B)
        a["Q"].add(Q)
        a["W"].add(kw["window_len"])
        a["variants"].add(variant(kw))
        for mabs, mrel, bad, _ in res:
            a["abs"], a["rel"], a["bad"] = max(a["abs"], mabs), max(a["rel"], mrel), a["bad"] + bad
        a["ms"] += device_ms(lambda: extract_xic_cuda(*args, **kw), KERNEL_REPS)
        a["bytes"] += nbytes
        a["ops"] += ops
    for (stage, pass_name), a in sorted(per_pass.items()):
        a["bound_ms"] = max(a["bytes"] / HBM_BYTES_PER_S, a["ops"] / FP32_OPS_PER_S) * 1e3
        log(
            f"{phase} {label} {stage} {pass_name}: {a['launches']} launches, every one held against the plain version; "
            f"B {sorted(a['B'])}, Q {sorted(a['Q'])}, W {sorted(a['W'])}, variants {sorted(a['variants'])}; max_abs="
            f"{a['abs']:.3g} max_rel={a['rel']:.3g} outside_tol={a['bad']}; kernel {a['ms']:.4f} ms warm, bound "
            f"{a['bound_ms']:.4f} ms ({a['bound_ms'] / a['ms']:.2f} of bound, {a['bytes'] / 1e6:.2f} MB)"
        )
        if a["bad"]:
            raise AssertionError(f"{label}: kernel disagrees with the plain version: {stage} {pass_name}")
        worst = [max(worst[0], a["abs"]), max(worst[1], a["rel"])]
    return worst, per_pass


class WarningsKept:
    """The port's WARNING records while it is entered."""

    def __enter__(self):
        import logging

        class Keep(logging.Handler):
            def emit(inner, record):
                self.records.append(record.getMessage())

        self.records, self.handler = [], Keep(logging.WARNING)
        logging.getLogger("alphadia_torch").addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger("alphadia_torch").removeHandler(self.handler)


def multiplexed_cli(root, label, gather_slab, lib, raw, tmp, name, card, launches, secs) -> dict:
    """``alphadia-torch`` on [13a]'s files with the e2e test's overrides (and
    ``gather_slab``): the output folder, the recorded launches (staged as the
    workflow's steps and final extraction), the run's workflow and PSMs."""
    import torch

    import alphadia_torch.cli as cli
    import alphadia_torch.search_step as search_step
    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.workflow.peptidecentric.optimization_handler import OptimizationHandler
    from torch_requant_readings import multiplex_argv

    kept, workflow_cls, process_batch = {}, search_step.PeptideCentricWorkflow, OptimizationHandler._process_batch

    class Captured(workflow_cls):
        def load(self, *a, **k):
            rec.stage = "load"
            return super().load(*a, **k)

        def extraction(self):
            rec.stage = "extraction"
            out = super().extraction()
            kept["workflow"], kept["psm"] = self, out[0]
            return out

    def staged(handler):
        rec.stage = f"step{len(handler.step_log)}"
        return process_batch(handler)

    kept["out"] = out = tmp / f"multiplex_out_{label}"
    argv = multiplex_argv(out, raw, lib, MP_RANDOM_STATE, gather_slab)
    search_step.PeptideCentricWorkflow = Captured
    OptimizationHandler._process_batch = staged
    code = 0
    try:
        with Recorder() as rec:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            xic_cuda.launches = 0
            t0 = time.perf_counter()
            try:
                cli.run(argv)
            except SystemExit as e:
                code = e.code
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_launch = xic_cuda.launches
    finally:
        search_step.PeptideCentricWorkflow = workflow_cls
        OptimizationHandler._process_batch = process_batch
    peak = torch.cuda.max_memory_allocated()
    log(f"[13a] alphadia-torch (multiplexed, channels 0, 4, 12; {label}): exit {code}, wall "
        f"{wall:.4f} s, {n_launch} launches, peak device memory {peak / 2**30:.3f} GiB ({name}, {card})")
    if code != 0:
        raise AssertionError(f"the multiplexed CLI ({label}) exited {code}")
    if n_launch != len(rec.calls) or n_launch == 0:
        raise AssertionError(f"multiplexed ({label}): {n_launch} launches counted, {len(rec.calls)} calls recorded")
    launches[f"multiplex_cli_{label}"] = n_launch
    secs[f"multiplex_cli_{label}"] = wall
    kept["calls"] = rec.calls
    return kept


def phase13a(root, name, card, launches, secs, tmp):
    """The multiplexed search through ``alphadia-torch`` on the card, gated
    on JAX's readings; then ``PeptideCentricWorkflow.requantify`` (the
    multiplexing handler) on the run's workflow, every launch held against
    the plain version."""
    import torch

    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.rawdata.mzml import read_mzml

    sys.path.insert(0, str(root / "tests"))
    from torch_workflow_worlds import library_sha256, multiplex_readings, spectra_sha256, write_multiplex_inputs

    t0 = time.perf_counter()
    d = tmp / "multiplex"
    d.mkdir()
    lib, raw, planted, _ = write_multiplex_inputs(d)
    sha = [spectra_sha256(read_mzml(raw)), library_sha256(lib)]
    n_chan = {c: int(((planted["channel"] == c) & (planted["decoy"] == 0)).sum()) for c in (0, 4)}
    log(
        f"[13a] inputs: the dimethyl digest of the 20-protein FASTA, channels 0 and 4 planted ({n_chan} target "
        f"precursors), {raw.name} {raw.stat().st_size / 2**20:.1f} MiB, {lib.name} {lib.stat().st_size / 2**20:.2f} "
        f"MiB; sha256 of the decoded arrays {sha}; made on the host in {time.perf_counter() - t0:.2f} s"
    )
    if sha != MP_INPUT_SHA256:
        raise AssertionError("multiplexed inputs: not the files of the JAX readings")

    worst = [0.0, 0.0]
    for label, gather_slab, jax, every_channel in (
        ("e2e", None, MP_JAX_READINGS, False),
        ("gather_slab_2048", MP_WIDE_SLAB, MP_WIDE_SLAB_JAX_READINGS, True),
    ):
        kept = multiplexed_cli(root, label, gather_slab, lib, raw, tmp, name, card, launches, secs)
        w = launches_against_plain("[13a]", label, kept["calls"])
        worst = [max(worst[0], w[0]), max(worst[1], w[1])]
        got = multiplex_readings(kept["out"])
        log(f"[13a] {label} readings: {json.dumps(got)}")
        n0 = got["channel_0"]
        checks = [
            ("channel_4 >= 0.5 x channel_0", got["channel_4"], (0.5 * n0, float("inf"))),
            ("channel_12 <= max(1, 0.05 x channel_0)", got["channel_12"], (0.0, max(1.0, 0.05 * n0))),
            ("channel_4 in JAX's band", got["channel_4"], (min(jax["channel_4"]) * (1 - MP_REL_BAND), float("inf"))),
            ("channel_12 in JAX's band", got["channel_12"], band(jax["channel_12"], rel=MP_REL_BAND)),
        ]
        if every_channel:
            checks += [(f"{k} in JAX's band", got[k], band(jax[k], rel=MP_REL_BAND)) for k in ("channel_0", "channel_4")]
        failed = []
        for k, v, (lo, hi) in checks:
            ok = lo <= v <= hi
            log(f"[13a] {label} gate {k}: {v:.4f} in [{lo:.4f}, {hi:.4f}] {'ok' if ok else 'FAILED'} ({name}, {card})")
            if not ok:
                failed.append(k)
        if failed:
            raise AssertionError(f"multiplexed search ({label}): gates failed: {failed}")
        if label == "e2e":
            handler_run = kept

    # the multiplexing handler on the e2e run's workflow (no caller in the
    # search step, as in the JAX package)
    wf, psm = handler_run["workflow"], handler_run["psm"]
    with Recorder() as rec:
        rec.stage = "requantify"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        xic_cuda.launches = 0
        t0 = time.perf_counter()
        channel_psm, channel_frag = wf.requantify(psm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = xic_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    if n_launch != len(rec.calls) or n_launch == 0:
        raise AssertionError(f"requantify: {n_launch} kernel launches counted, {len(rec.calls)} wrapper calls recorded")
    launches["multiplex_requantify"] = n_launch
    secs["multiplex_requantify"] = wall
    fdr = wf.config["fdr"]["fdr"]
    ch, q = np.asarray(channel_psm["channel"]), np.asarray(channel_psm["qval"])
    per_channel = {int(c): int(((ch == c) & (q <= fdr)).sum()) for c in (0, 4, 12)}
    log(
        f"[13a] requantify (multiplexing handler): {len(ch)} channel PSMs, at {fdr:.0%} channel FDR per channel "
        f"{json.dumps(per_channel)} (12 the decoy channel), {len(channel_frag['precursor_idx'])} fragments; wall "
        f"{wall:.4f} s, {n_launch} launches, peak device memory {peak / 2**30:.3f} GiB ({name}, {card})"
    )
    w, _ = all_launches_against_plain("[13a]", "requantify", rec.calls)
    if per_channel[0] == 0 or per_channel[4] == 0:
        raise AssertionError(f"requantify: a planted channel without PSMs at {fdr:.0%} channel FDR: {per_channel}")
    return [max(worst[0], w[0]), max(worst[1], w[1])]


def transfer_cli(root, lib, raws, tmp, name, card, launches, secs) -> tuple[dict, list]:
    """``alphadia-torch`` with ``transfer_library.enabled`` on [13b]'s files:
    the readings (``transfer_readings`` and the fallback
    warnings) and the largest errors of the launches held against the
    plain version (every launch of the transfer requant)."""
    import torch

    import alphadia_torch.cli as cli
    import alphadia_torch.search_step as search_step
    from alphadia_torch.constants.keys import SearchStepFiles
    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.outputs.search_plan_output import SearchPlanOutput
    from alphadia_torch.utils.parquet import read_parquet
    from alphadia_torch.workflow.peptidecentric.optimization_handler import OptimizationHandler
    from torch_requant_readings import transfer_argv
    from torch_workflow_worlds import transfer_readings

    captured = {"requant": [], "write": [], "library": []}
    workflow_cls, write = search_step.PeptideCentricWorkflow, search_step.write_parquet
    process_batch = OptimizationHandler._process_batch
    build_transfer = SearchPlanOutput._build_transfer_library

    class Captured(workflow_cls):
        def load(self, *a, **k):
            rec.stage = "load"
            return super().load(*a, **k)

        def extraction(self):
            rec.stage = "extraction"
            return super().extraction()

        def requantify_fragments(self, psm):
            rec.stage = "transfer_requant"
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = super().requantify_fragments(psm)
            torch.cuda.synchronize()
            captured["requant"].append(time.perf_counter() - t)
            return out

    def staged(handler):
        rec.stage = f"step{len(handler.step_log)}"
        return process_batch(handler)

    def timed_write(frame, path):
        t = time.perf_counter()
        write(frame, path)
        if Path(path).name == SearchStepFiles.FRAG_TRANSFER_FILE_NAME:
            captured["write"].append(time.perf_counter() - t)

    def timed_library(self, *a, **k):
        t = time.perf_counter()
        try:
            return build_transfer(self, *a, **k)
        finally:
            captured["library"].append(time.perf_counter() - t)

    out = tmp / "transfer_out"
    argv = transfer_argv(out, raws, lib, 0)
    search_step.PeptideCentricWorkflow = Captured
    OptimizationHandler._process_batch = staged
    search_step.write_parquet = timed_write
    SearchPlanOutput._build_transfer_library = timed_library
    code = 0
    try:
        with Recorder() as rec, WarningsKept() as warned:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            xic_cuda.launches = 0
            t0 = time.perf_counter()
            try:
                cli.run(argv)
            except SystemExit as e:
                code = e.code
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_launch = xic_cuda.launches
    finally:
        search_step.PeptideCentricWorkflow = workflow_cls
        OptimizationHandler._process_batch = process_batch
        search_step.write_parquet = write
        SearchPlanOutput._build_transfer_library = build_transfer
    peak = torch.cuda.max_memory_allocated()
    log(
        f"[13b] alphadia-torch (transfer_library.enabled, 2 runs): exit {code}, wall "
        f"{wall:.4f} s; the transfer requant per run {[round(x, 4) for x in captured['requant']]} s, the frag.transfer.parquet writes "
        f"{[round(x, 4) for x in captured['write']]} s, _build_transfer_library {captured['library']} s; peak device "
        f"memory {peak / 2**30:.3f} GiB ({name}, {card})"
    )
    if code != 0:
        raise AssertionError(f"the transfer CLI exited {code}")
    if n_launch != len(rec.calls) or n_launch == 0:
        raise AssertionError(f"transfer: {n_launch} kernel launches counted, {len(rec.calls)} wrapper calls recorded")
    requant_calls = [c for c in rec.calls if c[0] == "transfer_requant"]
    search_calls = [c for c in rec.calls if c[0] != "transfer_requant"]
    launches["transfer_cli_search"] = len(search_calls)
    launches["transfer_cli_requant"] = len(requant_calls)
    secs["transfer_cli"] = wall
    worst = launches_against_plain("[13b]", "search", search_calls)
    w, _ = all_launches_against_plain("[13b]", "transfer requant", requant_calls)
    worst = [max(worst[0], w[0]), max(worst[1], w[1])]

    got = transfer_readings(out)
    fallback = [m for m in warned.records if "keeping the scored set" in m]
    log(f"[13b] readings: {json.dumps(got)}; fallback warnings: {len(fallback)}")
    back = {k: read_parquet(out / f"speclib.transfer{k}.parquet") for k in ("", ".fragments")}
    if (len(back[""]["precursor_idx"]), len(back[".fragments"]["precursor_idx"])) != (got["transfer_psms"],
                                                                                         got["transfer_fragments"]):
        raise AssertionError("the transfer library read back with other sizes")
    got["fallback_warnings"] = len(fallback)
    return got, worst


def phase13b(root, name, card, launches, secs, tmp):
    """``transfer_library.enabled`` through ``alphadia-torch`` on the
    physics world's two runs, gated on JAX's readings, every launch of the
    transfer requant held against the plain version; then the integration
    test's physics world through the workflow's ``requantify_fragments``."""
    import torch

    from alphadia_torch.config import load_default_config
    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.rawdata.mzml import read_mzml

    sys.path.insert(0, str(root / "tests"))
    from torch_workflow_worlds import (
        REQUANT_CONFIG,
        library_sha256,
        requant_checks,
        requant_gates,
        spectra_sha256,
        write_requant_inputs,
        write_transfer_inputs,
    )

    t0 = time.perf_counter()
    d = tmp / "transfer"
    d.mkdir()
    lib, raws, planted, _, _ = write_transfer_inputs(d)
    sha = [spectra_sha256(read_mzml(r)) for r in raws] + [library_sha256(lib)]
    log(
        f"[13b] inputs: the physics world of the 20-protein FASTA, {int((planted.precursor_df['decoy'] == 0).sum())} "
        f"target precursors, {len(planted.fragment_df['mz_library'])} fragments planted, 2 runs "
        f"({sum(r.stat().st_size for r in raws) / 2**20:.1f} MiB); sha256 {sha}; made on the host in "
        f"{time.perf_counter() - t0:.2f} s"
    )
    if sha != TR_INPUT_SHA256:
        raise AssertionError("transfer inputs: not the files of the JAX readings")

    got, worst = transfer_cli(root, lib, raws, tmp, name, card, launches, secs)
    checks = []
    for i in range(2):
        checks += [(f"transfer rows > scored rows, run_{i}", got[f"transfer_rows_run_{i}"],
                    (got[f"scored_rows_run_{i}"] + 1, float("inf"))),
                   (f"transfer median > {TR_FRAGMENT_SPACE_MIN} x scored, run_{i}", got[f"transfer_median_run_{i}"],
                    (TR_FRAGMENT_SPACE_MIN * got[f"scored_median_run_{i}"] + 1e-9, float("inf")))]
    checks.append(("fallback warnings", got["fallback_warnings"], (0, 0)))
    for k in ("transfer_psms", "transfer_fragments", "transfer_precursors"):
        checks.append((k, got[k], band(TR_JAX_READINGS[k], rel=TR_REL_BAND)))
    failed = []
    for k, v, (lo, hi) in checks:
        ok = lo <= v <= hi
        log(f"[13b] gate {k}: {v:.4f} in [{lo:.4f}, {hi:.4f}] {'ok' if ok else 'FAILED'} ({name}, {card})")
        if not ok:
            failed.append(k)
    if failed:
        raise AssertionError(f"transfer library: gates failed: {failed}")

    # the integration test's physics world through the workflow
    from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow

    t0 = time.perf_counter()
    raw, searched, physics = write_requant_inputs(d)
    log(f"[13b] the integration test's physics world: {len(searched.precursor_df['precursor_idx'])} precursors "
        f"with decoys, made on the host in {time.perf_counter() - t0:.2f} s")
    cfg = load_default_config()
    cfg.update_layer({**REQUANT_CONFIG, "output_directory": str(tmp / "requant_out")}, name="requant")
    wf = PeptideCentricWorkflow("physics", cfg)
    t0 = time.perf_counter()
    wf.load(str(raw), searched)
    wf.search_parameter_optimization()
    psm, scored = wf.extraction()
    torch.cuda.synchronize()
    search_wall = time.perf_counter() - t0
    with Recorder() as rec:
        rec.stage = "transfer_requant"
        torch.cuda.reset_peak_memory_stats()
        xic_cuda.launches = 0
        t0 = time.perf_counter()
        requant_psm, requant_frag = wf.requantify_fragments(psm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = xic_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    if n_launch != len(rec.calls) or n_launch == 0:
        raise AssertionError(f"physics requant: {n_launch} launches counted, {len(rec.calls)} wrapper calls recorded")
    launches["transfer_requant_physics"] = n_launch
    secs["transfer_requant_physics"] = wall
    r = requant_checks(physics, searched.precursor_df, psm, scored, requant_psm, requant_frag)
    log(f"[13b] physics world: search {search_wall:.4f} s, requantify_fragments {wall:.4f} s ({n_launch} launches, "
        f"peak device memory {peak / 2**30:.3f} GiB); readings {json.dumps(r)} ({name}, {card})")
    w, _ = all_launches_against_plain("[13b]", "physics requant", rec.calls)
    worst = [max(worst[0], w[0]), max(worst[1], w[1])]
    failed = requant_gates(r)
    if failed:
        raise AssertionError(f"physics requant: the integration test's gates failed: {failed}")
    return worst


# ---------------------------------------------------------------------------
# [14] the three-step plan on the card
# ---------------------------------------------------------------------------
# alphadia-torch with general.transfer_step_enabled and mbr_step_enabled,
# library-free (library_prediction.enabled) on the FASTA and the two runs of
# [13b]'s physics world (tests/torch_workflow_worlds.multistep_argv), random
# state 0; the inputs held by the sha256 of the runs' decoded arrays and of
# the FASTA. The JAX package's CLI on the same files read, on the CPU
# (`PYTHONPATH=.:tests python tests/torch_multistep_readings.py
# --random-state 0 1 2 3 4 5`), the readings below; the port on the card
# (`... --packages port --device cuda`, PR 12 call 3) read its own six.
# The port's transfer library sits 2.5-3.5% above JAX's on these runs
# (ROADMAP §3; [13b]) and its models train on it: its six states lie beyond
# JAX's band by up to 0.0008 (RT R²), 0.0011 (RT 95th-percentile error),
# 0.0148 (charge accuracy) and 0.0360 (MS2 spectral angle), where on one
# transfer library the fits equal JAX's at 1e-3 (tests/test_torch_finetune.py,
# test_torch_transfer_library.py); and its later steps' identified and false
# shares by up to 0.0098 and 0.0108. The card's fine-tune once varied
# between calls, and the later steps magnified it (run_1 of the MBR step read
# 0.8366 and 0.8282 at state 0 in two calls; library_false_run_1 once rose
# above its gate): its training steps now run under PyTorch's deterministic
# algorithms (utils/device.deterministic), and two calls read the same values.
# Gates: the transfer library within 5% of JAX's band ([13b]'s); each model
# metric within JAX's band widened by MS_METRIC_MARGIN (that distance and
# about a third more, at least 0.005); the IDs as [12c] gates them with
# MS_ID_SLACK in place of its 0.005 (0.005 + 0.01 for that distance); the
# protein groups and the MBR library within 2% of JAX's band
MS_INPUT_SHA256 = [
    "64410a860d54f8c8480008e0b3343a8430e9e867b056c984c581fa4c71ffd001",
    "7825b677dc6588a229cd076ac8730c5191bc980a5240d10f4cc69395a1948a42",
    "78c49b673ca6ee594498a03ac9ffd239006d0710e93b7b124894db17271fe2d7",
]
MS_JAX_READINGS = {  # random states 0, 1, 2, 3, 4, 5
    "transfer_psms": [3452, 3455, 3458, 3460, 3465, 3451],
    "transfer_precursors": [1934, 1967, 1973, 1966, 1931, 1970],
    "rt_r2": [0.939328, 0.943848, 0.930963, 0.936909, 0.94225, 0.938813],
    "rt_abs_error_95": [0.120577, 0.117962, 0.130629, 0.127038, 0.121184, 0.118504],
    "charge_accuracy": [0.869377, 0.866106, 0.871496, 0.864331, 0.868237, 0.868494],
    "ms2_spectral_angle": [0.598224, 0.597276, 0.598674, 0.59817, 0.600373, 0.597334],
    "library_identified_run_0": [0.823633, 0.822581, 0.819776, 0.827139, 0.822581, 0.821178],
    "library_false_run_0": [0.258222, 0.259514, 0.255918, 0.256462, 0.256795, 0.272098],
    "library_identified_run_1": [0.807854, 0.821178, 0.821529, 0.823282, 0.812412, 0.821529],
    "library_false_run_1": [0.246377, 0.263073, 0.262987, 0.264919, 0.253994, 0.264587],
    "library_protein_groups": [20, 20, 20, 20, 20, 20],
    "mbr_identified_run_0": [0.839762, 0.843268, 0.840813, 0.837307, 0.840813, 0.839762],
    "mbr_false_run_0": [0.267145, 0.273626, 0.271321, 0.273126, 0.271429, 0.274277],
    "mbr_identified_run_1": [0.842216, 0.840112, 0.846073, 0.845722, 0.838008, 0.839411],
    "mbr_false_run_1": [0.282092, 0.269734, 0.273697, 0.277493, 0.275437, 0.275903],
    "mbr_protein_groups": [20, 20, 20, 20, 20, 20],
    "mbr_library_precursors": [2744, 2790, 2779, 2783, 2760, 2764],
}
MS_TRANSFER_REL_BAND = 0.05
MS_REL_BAND = 0.02
MS_METRIC_MARGIN = {"rt_r2": 0.005, "rt_abs_error_95": 0.005, "charge_accuracy": 0.02, "ms2_spectral_angle": 0.05}
MS_ID_SLACK = 0.015
MS_PREDICT_TOL = 1e-5
MS_KERNEL_REPS = 5  # each launch of the plan timed alone: 812 launches
MS_PROFILE_PHASES = ("alphadia_torch.load", "alphadia_torch.optimization", "alphadia_torch.extraction")


def trace_readings(path: Path) -> dict:
    """A Chrome trace's kernel events, those of the XIC kernel, and the
    ``alphadia_torch.*`` phases it names: counted while the file streams
    past (a raw file's trace holds millions of events)."""
    keys = {"kernel_events": b'"cat": "kernel"', "xic_kernel_events": b"xic_kernel"}
    keys.update({p: f'"name": "{p}"'.encode() for p in MS_PROFILE_PHASES})
    counts, tail = dict.fromkeys(keys, 0), b""
    with open(path, "rb") as f:
        while chunk := f.read(1 << 26):
            buf = tail + chunk
            cut = max(len(buf) - 64, 0)  # a key that straddles the cut is counted with the next chunk
            for k, needle in keys.items():
                counts[k] += buf.count(needle, 0, cut + len(needle) - 1) if cut else 0
            tail = buf[cut:]
    for k, needle in keys.items():
        counts[k] += tail.count(needle)
    return {"xic_kernel_events": counts["xic_kernel_events"], "kernel_events": counts["kernel_events"],
            "spans": [p for p in MS_PROFILE_PHASES if counts[p]], "mb": path.stat().st_size / 1e6}


# the traced run's calibration loop, short (that of the requant integration
# test's world): a traced step of one run at the default loop took 110.9 s
# against 44 s untraced (PR 12 call 7), its trace 1.9 GB of 1.9 M kernel
# events, nearly all the FDR fits' graph replays
MS_PROFILE_CALIBRATION = {"batch_size": 150, "optimization_lock_target": 30, "min_steps": 2, "max_steps": 4}


def profiled_transfer_step(raw, fasta, tmp, name, card) -> list:
    """``alphadia-torch --profile-dir`` with the transfer library and
    learning on one run, library-free, no later step: the trace's checks
    (one trace holding the XIC kernel's CUDA events and the workflow's
    phases, the tuned models written)."""
    import torch

    import alphadia_torch.cli as cli
    from alphadia_torch.models.finetune import MODEL_DIR_NAME
    from alphadia_torch.ops import xic_cuda
    from torch_workflow_worlds import multistep_argv

    prof, out = tmp / "multistep_prof", tmp / "multistep_prof_out"
    argv = multistep_argv(out, [raw], fasta, 0, profile_dir=prof, mbr=False)
    cfg = json.loads(argv[argv.index("--config-dict") + 1])
    cfg["general"]["transfer_step_enabled"] = False
    cfg.update(transfer_library={"enabled": True}, transfer_learning={"enabled": True},
               calibration=MS_PROFILE_CALIBRATION)
    argv[argv.index("--config-dict") + 1] = json.dumps(cfg)
    code = 0
    torch.cuda.synchronize()
    xic_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        cli.run(argv)
    except SystemExit as e:
        code = e.code
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    traces = sorted((prof / raw.stem).glob("trace*.json"))
    found = [trace_readings(t) for t in traces]
    models = (out / MODEL_DIR_NAME / "models.pkl").exists()
    log(f"[14] the transfer step on one run with --profile-dir (calibration {json.dumps(MS_PROFILE_CALIBRATION)}): "
        f"exit {code}, wall {wall:.4f} s, {xic_cuda.launches} kernel launches, models written {models}; traces "
        f"{[t.name for t in traces]}: {json.dumps(found)} ({name}, {card})")
    checks = [("profiled step exit", code, (0, 0)), ("profiled step models written", int(models), (1, 1)),
              ("traces", len(traces), (1, 1))]
    for i, f in enumerate(found):
        checks.append((f"trace {i} xic_kernel events", f["xic_kernel_events"], (1, float("inf"))))
        checks.append((f"trace {i} phase spans", len(f["spans"]), (len(MS_PROFILE_PHASES), len(MS_PROFILE_PHASES))))
    return checks


def phase14(root, name, card, launches, secs, tmp):
    """The three-step plan through ``alphadia-torch`` on the card, gated on
    the JAX CLI's readings; then the plan on one run with ``--profile-dir``."""
    import torch

    import alphadia_torch.cli as cli
    import alphadia_torch.search_step as search_step
    from alphadia_torch.models import finetune
    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.outputs.search_plan_output import SearchPlanOutput
    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.rawdata.mzml import read_mzml
    from alphadia_torch.utils.parquet import read_parquet
    from alphadia_torch.workflow.peptidecentric.optimization_handler import OptimizationHandler

    sys.path.insert(0, str(root / "tests"))
    from torch_workflow_worlds import multistep_argv, multistep_readings, physics_truth, spectra_sha256
    from torch_workflow_worlds import write_transfer_inputs

    t0 = time.perf_counter()
    d = tmp / "multistep"
    d.mkdir()
    _, raws, planted, _, _ = write_transfer_inputs(d)
    fasta = d / "db.fasta"
    spectra = [read_mzml(r) for r in raws]
    cycle_rts = [DiaData.from_spectra(x).cycle_rt for x in spectra]
    sha = [spectra_sha256(x) for x in spectra] + [hashlib.sha256(fasta.read_bytes()).hexdigest()]
    del spectra
    truth = physics_truth(planted)
    log(f"[14] inputs: the physics world's FASTA and 2 runs; sha256 {sha}; made on the host in "
        f"{time.perf_counter() - t0:.2f} s")
    if sha != MS_INPUT_SHA256:
        raise AssertionError("multistep inputs: not the files of the JAX readings")

    steps, fits, managers = [], [], []
    workflow_cls = search_step.PeptideCentricWorkflow
    process_batch = OptimizationHandler._process_batch
    run, build_model, save = search_step.SearchStep.run, SearchPlanOutput._build_transfer_model, finetune.FinetuneManager.save

    class Captured(workflow_cls):
        def load(self, *a, **k):
            rec.stage = "load"
            return super().load(*a, **k)

        def extraction(self):
            rec.stage = "extraction"
            return super().extraction()

        def requantify_fragments(self, psm):
            rec.stage = "transfer_requant"
            return super().requantify_fragments(psm)

    def staged(handler):
        rec.stage = f"step{len(handler.step_log)}"
        return process_batch(handler)

    def timed_run(self):
        entry = {"dir": Path(self.output_folder).name, "first_call": len(rec.calls)}
        steps.append(entry)
        t = time.perf_counter()
        try:
            return run(self)
        finally:
            torch.cuda.synchronize()
            entry["wall"] = time.perf_counter() - t
            entry["calls"] = len(rec.calls) - entry["first_call"]

    def timed_model(self, *a, **k):
        t = time.perf_counter()
        try:
            return build_model(self, *a, **k)
        finally:
            fits.append({**self.timings, "wall": time.perf_counter() - t})

    def kept(self, directory):
        managers.append(self)
        return save(self, directory)

    def plan(argv):
        search_step.PeptideCentricWorkflow = Captured
        OptimizationHandler._process_batch = staged
        search_step.SearchStep.run = timed_run
        SearchPlanOutput._build_transfer_model = timed_model
        finetune.FinetuneManager.save = kept
        code = 0
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            xic_cuda.launches = 0
            t = time.perf_counter()
            try:
                cli.run(argv)
            except SystemExit as e:
                code = e.code
            torch.cuda.synchronize()
            return code, time.perf_counter() - t, xic_cuda.launches, torch.cuda.max_memory_allocated()
        finally:
            search_step.PeptideCentricWorkflow = workflow_cls
            OptimizationHandler._process_batch = process_batch
            search_step.SearchStep.run = run
            SearchPlanOutput._build_transfer_model = build_model
            finetune.FinetuneManager.save = save

    out = tmp / "multistep_out"
    with Recorder() as rec:
        code, wall, n_launch, peak = plan(multistep_argv(out, raws, fasta, 0))
    log(f"[14] alphadia-torch (transfer step -> library step -> MBR step, library-free, 2 runs): exit {code}, wall "
        f"{wall:.4f} s, peak device memory {peak / 2**30:.3f} GiB ({name}, {card})")
    if code != 0:
        raise AssertionError(f"the three-step plan exited {code}")
    if n_launch != len(rec.calls) or n_launch == 0:
        raise AssertionError(f"three-step plan: {n_launch} kernel launches counted, {len(rec.calls)} wrapper calls recorded")
    if [x["dir"] for x in steps] != ["transfer", "library", out.name] or len(fits) != 1 or len(managers) != 1:
        raise AssertionError(f"three-step plan: steps ran in {[x['dir'] for x in steps]}, {len(fits)} model builds")

    worst = [0.0, 0.0]
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    for label, entry in zip(("transfer_step", "library_step", "mbr_step"), steps):
        calls = rec.calls[entry["first_call"] : entry["first_call"] + entry["calls"]]
        search = [c for c in calls if c[0] != "transfer_requant"]
        requant = [c for c in calls if c[0] == "transfer_requant"]
        launches[f"multistep_{label}"] = len(calls)
        secs[f"multistep_{label}"] = entry["wall"]
        w = launches_against_plain("[14]", label, search)
        worst = [max(worst[0], w[0]), max(worst[1], w[1])]
        if requant:
            w, _ = all_launches_against_plain("[14]", f"{label} transfer requant", requant)
            worst = [max(worst[0], w[0]), max(worst[1], w[1])]
        per_pass = summed_device_ms(calls, flush, reps=MS_KERNEL_REPS)
        for (stage, pass_name), acc in sorted(per_pass.items()):
            log(
                f"[14] {label} kernel, {stage} {pass_name}: {acc['launches']} launches, {acc['ms']:.4f} ms warm "
                f"({acc['bound_ms'] / acc['ms']:.2f} of bound), L2 flushed {acc['flushed_ms']:.4f} ms, bound "
                f"{acc['bound_ms']:.4f} ms ({acc['bytes'] / 1e6:.2f} MB) ({name}, {card})"
            )
        kernel_ms = sum(x["ms"] for x in per_pass.values())
        log(f"[14] {label}: wall {entry['wall']:.4f} s; {len(calls)} kernel launches ({len(requant)} of the transfer "
            f"requant), summed {kernel_ms:.4f} ms warm, {kernel_ms / (entry['wall'] * 1e3):.5f} of the step's wall "
            f"({name}, {card})")
    del flush
    fit = fits[0]
    for model in ("rt", "charge", "ms2", "ccs"):
        n_steps = fit.get(f"finetune_{model}_steps", 0)
        log(f"[14] fit {model}: {fit[f'finetune_{model}_s']:.4f} s, {fit.get(f'finetune_{model}_epochs', 0)} epochs, "
            f"{n_steps} steps, {fit[f'finetune_{model}_s'] * 1e3 / max(n_steps, 1):.3f} ms a step (the predictions "
            f"and the metrics included) ({name}, {card})")
    log(f"[14] _build_transfer_model {fit['wall']:.4f} s, _build_transfer_library {fit.get('transfer_library_s', 0):.4f} s")

    got = multistep_readings(out, truth, cycle_rts)
    log(f"[14] readings: {json.dumps(got)}")
    jax = MS_JAX_READINGS
    checks = [(k, got[k], band(jax[k], rel=MS_TRANSFER_REL_BAND)) for k in ("transfer_psms", "transfer_precursors")]
    checks += [(k, got[k], band(jax[k], add=m)) for k, m in MS_METRIC_MARGIN.items()]
    for step in ("library", "mbr"):
        for r in range(2):
            k = f"{step}_identified_run_{r}"
            checks.append((k, got[k], (min(jax[k]) - MS_ID_SLACK, 1.0)))
            k = f"{step}_false_run_{r}"
            checks.append((k, got[k], (0.0, max(0.02, max(jax[k]) + MS_ID_SLACK))))
        checks.append((f"{step}_protein_groups", got[f"{step}_protein_groups"], band(jax[f"{step}_protein_groups"],
                                                                                      rel=MS_REL_BAND)))
    checks.append(("mbr_library_precursors", got["mbr_library_precursors"], band(jax["mbr_library_precursors"],
                                                                                rel=MS_REL_BAND)))

    # models.pkl read again on the card against the live models
    live = managers[0]
    back = finetune.FinetuneManager.load(out / "transfer" / finetune.MODEL_DIR_NAME)
    tl = read_parquet(out / "transfer" / "speclib.transfer.parquet")
    args = [list(tl["sequence"]), list(tl["mods"]), list(tl["mod_sites"])]
    z = tl["charge"].astype(np.int32)
    diffs = {}
    for method, extra in (("predict_rt", ()), ("predict_charge", ()), ("predict_ms2", (z,))):
        diffs[method] = float(np.abs(getattr(back, method)(*args, *extra) - getattr(live, method)(*args, *extra)).max())
    log(f"[14] models.pkl read again ({sorted(back.variables)}): largest difference from the live models "
        f"{json.dumps(diffs)} on the {len(z)} transfer PSMs")
    checks += [(f"models.pkl {k}", v, (0.0, MS_PREDICT_TOL)) for k, v in diffs.items()]

    checks += profiled_transfer_step(raws[0], fasta, tmp, name, card)

    failed = []
    for k, v, (lo, hi) in checks:
        ok = lo <= v <= hi
        log(f"[14] gate {k}: {v:.6g} in [{lo:.6g}, {hi:.6g}] {'ok' if ok else 'FAILED'} ({name}, {card})")
        if not ok:
            failed.append(k)
    if failed:
        raise AssertionError(f"three-step plan: gates failed: {failed}")
    return worst


# ---------------------------------------------------------------------------
# 15. several processes and several shards on the one card
# ---------------------------------------------------------------------------
# The machine holds one card, so the card named twice (and four times)
# stands for several cards, and two processes share it in one gloo group.
# Each process of [15c] and [15d] must end within P15_TIMEOUT_S; where one
# does not, every process of the group is killed. (b): the PSM features of
# the sharded drivers against one device's, relative to max(|value|, 1),
# where they are not equal
P15_TIMEOUT_S = 240
P15_REPS = 5
P15_FEATURE_TOL = 1e-6
P15_SLEEP_CYCLES = 2_000_000  # a launch's share of the sleep that hides the host's enqueue (~1 ms)
_GROUP_ENV = (
    "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
    "ALPHADIA_TPU_COORDINATOR", "ALPHADIA_TPU_NUM_PROCESSES", "ALPHADIA_TPU_PROCESS_ID",
    "SLURM_JOB_ID", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID",
)


def replaced_sharded(root: Path) -> str:
    """``file:line`` of the JAX package's per-shard Pallas route
    (``extract_xic_pallas_sharded``) in this checkout."""
    for path in sorted(root.glob("*/parallel/shard_ops.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if line.startswith("def extract_xic_pallas_sharded("):
                return f"{path.relative_to(root)}:{i}"
    raise FileNotFoundError("the sharded Pallas route is not in this checkout")


def launches_ms(fns, reps=P15_REPS) -> float:
    """Device ms of one run of every function in ``fns`` back to back (mean
    of ``reps`` runs, each timed alone), the card kept busy by a sleep while
    the host enqueues a run (a run's few hundred launches stay within the
    card's queue of launches, so the host never waits for it)."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(P15_SLEEP_CYCLES * len(fns))
        start.record()
        for fn in fns:
            fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def phase15a(calls, plain_ms_of, name, card) -> None:
    """(a) Every recorded launch of phase [3] through
    ``extract_xic_cuda_sharded`` over the card named 2 and 4 times, where
    its batch splits: equal to the unsharded kernel at atol 0 and held to
    the plain version; per pass the sharded and the unsharded device ms
    and the bound. The function is the counterpart of the JAX package's
    ``extract_xic_pallas_sharded``, which only that package's tests call;
    the drivers shard through ``run_on_devices`` ([15b])."""
    import torch

    from alphadia_torch.ops.xic import extract_xic_packed
    from alphadia_torch.ops.xic_cuda import extract_xic_cuda
    from alphadia_torch.parallel.shard_ops import extract_xic_cuda_sharded

    dev = torch.device("cuda", torch.cuda.current_device())
    passes, worst, skipped = {}, [0.0, 0.0], {2: 0, 4: 0}
    for i, (stage, args, kw) in enumerate(calls):
        store, cell, slot, qmz, tol, c0 = args
        want = extract_xic_cuda(*args, **kw)
        want = want if isinstance(want, tuple) else (want,)
        plain = None
        for n in (2, 4):
            if slot.shape[0] % n:
                skipped[n] += 1
                continue

            def sharded(n=n, store=store, cell=cell, slot=slot, qmz=qmz, tol=tol, c0=c0, kw=kw):
                return extract_xic_cuda_sharded([dev] * n, [store] * n, [cell] * n, slot, qmz, tol, c0, **kw)

            got = sharded()
            got = got if isinstance(got, tuple) else (got,)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"[15a] {stage} launch {i}: the {n}-way route differs from the unsharded kernel")
            if plain is None:
                plain = extract_xic_packed(*args, **kw)
            for plane, (mabs, mrel, bad, _) in zip(("intensity", "mz"), plane_errors(got, plain, kw)):
                if bad:
                    raise AssertionError(f"[15a] {stage} launch {i} {plane}: the {n}-way route disagrees with the plain version")
                worst = [max(worst[0], mabs), max(worst[1], mrel)]
            acc = passes.setdefault((stage, n), {"sharded": [], "unsharded": [], "bytes": 0, "ops": 0, "plain_ms": 0.0})
            acc["sharded"].append(sharded)
            acc["unsharded"].append(lambda args=args, kw=kw: extract_xic_cuda(*args, **kw))
            nbytes, ops = work(args, kw)
            acc["bytes"] += nbytes
            acc["ops"] += ops
            acc["plain_ms"] += plain_ms_of[i]
    total = dict.fromkeys(("launches", "ms", "unsharded_ms", "plain_ms", "bytes", "ops"), 0)
    for (stage, n), acc in sorted(passes.items()):
        s_ms, u_ms = launches_ms(acc["sharded"]), launches_ms(acc["unsharded"])
        bound = max(acc["bytes"] / HBM_BYTES_PER_S, acc["ops"] / FP32_OPS_PER_S) * 1e3
        log(
            f"[15a] {stage:17s} over cuda:0 x{n}: {len(acc['sharded'])} launches, sharded {s_ms:.4f} ms, unsharded "
            f"{u_ms:.4f} ms, bound {bound:.4f} ms ({bound / s_ms:.2f} of it sharded), each equal to the unsharded "
            f"kernel ({name}, {card})"
        )
        if n == 2:
            for k, v in (("launches", len(acc["sharded"])), ("ms", s_ms), ("unsharded_ms", u_ms),
                         ("plain_ms", acc["plain_ms"]), ("bytes", acc["bytes"]), ("ops", acc["ops"])):
                total[k] += v
    if not total["launches"]:
        raise AssertionError("[15a] no recorded launch splits in two")
    by_bytes = total["bytes"] / HBM_BYTES_PER_S >= total["ops"] / FP32_OPS_PER_S
    total["bound_ms"] = max(total["bytes"] / HBM_BYTES_PER_S, total["ops"] / FP32_OPS_PER_S) * 1e3
    total["bound_by"] = "bytes" if by_bytes else "operations"
    total["max_abs_err"] = worst[0]
    log(
        f"[15a] the 2-way route on {total['launches']} of {len(calls)} launches ({skipped[2]} with an odd batch; 4-way: "
        f"{len(calls) - skipped[4]}): sharded {total['ms']:.4f} ms, unsharded {total['unsharded_ms']:.4f} ms, plain "
        f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms ({total['bound_by']}); against the plain "
        f"version max_abs={worst[0]:.3g} max_rel={worst[1]:.3g} ({name}, {card})"
    )


def phase15b(worlds, name, card) -> dict:
    """(b) ``CandidateSelection`` -> ``CandidateScoring`` with
    ``mesh_devices`` 2 over the card named twice, on the 3D world and the 4D
    quarter world of [8], against the same drivers on the card alone: the
    same candidates and PSMs, every launch through the sharded route. Then
    every launch of both runs again alone: per pass the sharded drivers'
    summed kernel ms beside one device's and the bound, each sharded launch
    held against the plain version. Returns the route's readings for the
    kernels line (its launches are those of the sharded drivers' runs)."""
    import torch

    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.ops.xic import extract_xic_packed
    from alphadia_torch.parallel import shard_ops
    from alphadia_torch.search.scoring import FEATURE_COLUMNS, CandidateScoring, ScoringConfig
    from alphadia_torch.search.selection import CandidateSelection, SelectionConfig

    dev = torch.device("cuda", torch.cuda.current_device())
    quarter = make_world(N_PEPTIDES_4D // 4, N_CYCLES, n_windows=3, with_mobility=True)
    route = dict.fromkeys(("launches", "ms", "plain_ms", "bytes", "ops", "max_abs_err"), 0)
    for label, tag, (dia, prec, frag) in (("3D", "", worlds[""]), ("4D quarter", "_4d_quarter", quarter)):
        scfg = SelectionConfig(rt_tolerance=60.0, candidate_count=3, mesh_devices=2)
        ccfg = ScoringConfig(batch_size=8192, collect_fragments=True, mesh_devices=2)
        out, walls, recorded = {}, {}, {}
        for who, kw in (("one", {"device": dev}), ("two", {"devices": [dev, dev]})):
            torch.cuda.synchronize()
            xic_cuda.launches = shard_ops.launches = 0
            with Recorder() as rec:
                rec.stage = who
                t0 = time.perf_counter()
                cands = CandidateSelection(dia, prec, frag, scfg, **kw)()
                psm, frags = CandidateScoring(dia, prec, frag, ccfg, **kw)(cands)
                torch.cuda.synchronize()
                walls[who] = time.perf_counter() - t0
            out[who] = (cands, psm, frags, xic_cuda.launches, shard_ops.launches)
            recorded[who] = rec.calls
        (c1, p1, f1, n1, _), (c2, p2, f2, n2, r2) = out["one"], out["two"]
        route["launches"] += r2
        if n2 == 0 or r2 != n2 or len(recorded["two"]) != n2:
            raise AssertionError(
                f"[15b] {label}: {n2} launches, {r2} of them through the sharded route, {len(recorded['two'])} recorded"
            )
        for c in c1:
            if not np.array_equal(c1[c], c2[c]):
                raise AssertionError(f"[15b] {label}: candidates differ in {c}")
        for c in ("precursor_idx", "rank"):
            if not np.array_equal(p1[c], p2[c]):
                raise AssertionError(f"[15b] {label}: PSM rows differ ({c})")
        worst = 0.0
        for c in FEATURE_COLUMNS:
            a, b = p1[c].astype(np.float64), p2[c].astype(np.float64)
            d = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
            worst = max(worst, float(np.nanmax(d)) if d.size else 0.0)
            if not np.array_equal(np.isnan(a), np.isnan(b)):
                raise AssertionError(f"[15b] {label}: NaNs differ in {c}")
        fr = all(np.array_equal(f1[c], f2[c], equal_nan=f1[c].dtype.kind == "f") for c in f1)
        log(
            f"[15b] {label}: {len(c1['precursor_idx'])} candidates equal, {len(p1['precursor_idx'])} PSMs, largest "
            f"feature difference {worst:.3g} (relative to max(|value|, 1)), fragments equal {fr}; one card "
            f"{walls['one']:.4f} s ({n1} launches), cuda:0 x2 {walls['two']:.4f} s ({n2} launches, {r2} through the "
            f"sharded route) ({name}, {card})"
        )
        if worst > P15_FEATURE_TOL:
            raise AssertionError(f"[15b] {label}: PSM features differ by {worst:.3g}")
        # the drivers' own launches run again alone, as phase [5] times them
        per_pass = {}
        for who, calls in recorded.items():
            for _, args, kw in calls:
                acc = per_pass.setdefault((pass_of(kw), who), dict.fromkeys(("launches", "ms", "plain_ms", "bytes", "ops"), 0))
                acc["launches"] += 1
                acc["ms"] += device_ms(lambda: xic_cuda.extract_xic_cuda(*args, **kw), KERNEL_REPS)
                nbytes, ops = work(args, kw)
                acc["bytes"] += nbytes
                acc["ops"] += ops
                if who == "two":
                    acc["plain_ms"] += device_ms(lambda: extract_xic_packed(*args, **kw), PLAIN_REPS, warmup=1)
                    for plane, (mabs, _, bad, _) in zip(("intensity", "mz"), compare(args, kw)):
                        if bad:
                            raise AssertionError(f"[15b] {label} {pass_of(kw)} {plane}: a shard's launch disagrees with the plain version")
                        route["max_abs_err"] = max(route["max_abs_err"], mabs)
        for pass_name in sorted({p for p, _ in per_pass}):
            s_, u = per_pass[(pass_name, "two")], per_pass[(pass_name, "one")]
            bound = max(s_["bytes"] / HBM_BYTES_PER_S, s_["ops"] / FP32_OPS_PER_S) * 1e3
            log(
                f"[15b] {label} {pass_name}: the sharded drivers' {s_['launches']} launches {s_['ms']:.4f} ms warm "
                f"(plain {s_['plain_ms']:.4f} ms), one device's {u['launches']} launches {u['ms']:.4f} ms, bound of the "
                f"sharded launches {bound:.4f} ms ({bound / s_['ms']:.2f} of it), each held against the plain version "
                f"({name}, {card})"
            )
            for k in ("ms", "plain_ms", "bytes", "ops"):
                route[k] += s_[k]
    by_bytes = route["bytes"] / HBM_BYTES_PER_S >= route["ops"] / FP32_OPS_PER_S
    route["bound_ms"] = max(route["bytes"] / HBM_BYTES_PER_S, route["ops"] / FP32_OPS_PER_S) * 1e3
    route["bound_by"] = "bytes" if by_bytes else "operations"
    log(
        f"[15b] the sharded route in the drivers: {route['launches']} launches, {route['ms']:.4f} ms warm, plain "
        f"{route['plain_ms']:.4f} ms, bound {route['bound_ms']:.4f} ms ({route['bound_by']}), max_abs="
        f"{route['max_abs_err']:.3g} against the plain version ({name}, {card})"
    )
    return route


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def group_env(rank: int, contract: str, port: int) -> dict:
    """The environment of process ``rank`` of two: ``torchrun``'s or the JAX
    package's contract, on a fresh port; any inherited group setting cleared."""
    env = {k: v for k, v in os.environ.items() if k not in _GROUP_ENV}
    if contract == "torchrun":
        env.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    else:
        env.update(ALPHADIA_TPU_COORDINATOR=f"127.0.0.1:{port}", ALPHADIA_TPU_NUM_PROCESSES="2",
                   ALPHADIA_TPU_PROCESS_ID=str(rank))
    return env


def run_group(root, argv, contract, tmp, label) -> tuple[list, float]:
    """``alphadia-torch argv`` as two processes of one group on the card
    (``chip_smoke.py --cli-process``); each one's report (its exit code
    added) and the wall of the whole. Kills both when one outlives
    ``P15_TIMEOUT_S``."""
    port = free_port()
    procs = []
    t0 = time.perf_counter()
    for rank in (0, 1):
        report, out_log = tmp / f"{label}_rank{rank}.json", tmp / f"{label}_rank{rank}.log"
        with open(out_log, "w") as f:
            proc = subprocess.Popen([sys.executable, str(root / "chip_smoke.py"), "--cli-process", str(report), *argv],
                                    cwd=root, env=group_env(rank, contract, port), stdout=f, stderr=subprocess.STDOUT)
        procs.append((proc, report, out_log))
    try:
        for proc, _, _ in procs:
            proc.wait(timeout=max(1.0, P15_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"[15] {label}: a process outlived {P15_TIMEOUT_S} s") from e
    finally:
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    reports = []
    for rank, (proc, report, out_log) in enumerate(procs):
        r = json.loads(report.read_text()) if report.exists() else {"rank": rank, "missing": True}
        r["exit"] = proc.returncode
        reports.append(r)
        if proc.returncode != 0 or r.get("missing"):
            log(f"[15] {label} rank {rank} exit {proc.returncode}, its output's end:\n"
                + "\n".join(out_log.read_text().splitlines()[-25:]))
    return reports, wall


def cli_process(args) -> int:
    """One process of [15c] / [15d]: ``alphadia-torch`` (``cli.run``) with
    ``args[1:]``, its group from the environment; writes to ``args[0]`` its
    rank, exit code, the runs it searched, whether it built the cross-run
    outputs, whether they existed when it returned, its wall and its kernel
    launches."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    report, argv = Path(args[0]), list(args[1:])
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import alphadia_torch.cli as cli
    import alphadia_torch.search_step as search_step
    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.outputs.search_plan_output import SearchPlanOutput
    from alphadia_torch.parallel import distributed

    searched, builds = [], []
    process_raw, build = search_step.SearchStep._process_raw_file, SearchPlanOutput.build

    def recorded_raw(self, raw_path, raw_name, quant_dir):
        searched.append(raw_name)
        return process_raw(self, raw_path, raw_name, quant_dir)

    def counted_build(self, *a, **k):
        builds.append(1)
        return build(self, *a, **k)

    search_step.SearchStep._process_raw_file = recorded_raw
    SearchPlanOutput.build = counted_build
    out = Path(argv[argv.index("-o") + 1])
    code = 0
    t0 = time.perf_counter()
    try:
        cli.run(argv)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    torch.cuda.synchronize()
    report.write_text(json.dumps({
        "rank": distributed.process_index(), "count": distributed.process_count(), "code": code,
        "searched": searched, "builds": len(builds),
        "built_at_return": (out / "stat.tsv").exists() and (out / "precursors.parquet").exists(),
        "wall": time.perf_counter() - t0, "launches": xic_cuda.launches,
        "devices": [str(d) for d in distributed.local_devices()],
    }))
    return code


def psm_differences(a: dict, b: dict) -> str:
    """Where two runs' ``psm.parquet`` frames part: rows, and the largest
    difference of the numeric columns where the rows agree."""
    if list(a) != list(b):
        return f"columns differ: {sorted(set(a) ^ set(b))}"
    na, nb = len(a["precursor_idx"]), len(b["precursor_idx"])
    if na != nb or not np.array_equal(a["precursor_idx"], b["precursor_idx"]):
        common = len(set(a["precursor_idx"].tolist()) & set(b["precursor_idx"].tolist()))
        return f"{na} against {nb} PSMs, {common} precursors in common"
    worst = {c: float(np.nanmax(np.abs(a[c].astype(np.float64) - b[c].astype(np.float64))))
             for c in a if a[c].dtype.kind in "fiu" and a[c].size and not np.array_equal(a[c], b[c], equal_nan=True)}
    return f"the same {na} PSMs; columns that differ (largest difference): {json.dumps(worst)}" if worst else "equal"


def phase15c(root, cli_inputs, name, card, secs, tmp):
    """(c) ``alphadia-torch`` on [9]'s two runs and library as two processes
    on the card, in ``torchrun``'s and in the JAX package's contract: each
    process searched one run, process 0 built the outputs over both once,
    process 1 returned after they existed; IDs per run and protein groups
    in [9]'s JAX band; each run's PSMs against the one-process CLI of [9]."""
    from alphadia_torch.utils.parquet import read_parquet
    from alphadia_torch.utils.tsv import read_tsv
    from torch_workflow_worlds import cli_readings

    raws, lib, truth, cycle_rts = cli_inputs
    for contract in ("torchrun", "jax"):
        out = tmp / f"p15_{contract}"
        argv = ["-o", str(out), "-f", str(raws[0]), "-f", str(raws[1]), "-l", str(lib), "--quant-dir",
                str(out / "quant"), "--config-dict", json.dumps({"general": {"random_state": 0, "log_level": "PROGRESS"}})]
        reports, wall = run_group(root, argv, contract, tmp, f"cli_{contract}")
        r0, r1 = reports
        stat = read_tsv(out / "stat.tsv") if (out / "stat.tsv").exists() else {"run": []}
        precursors = read_parquet(out / "precursors.parquet") if (out / "precursors.parquet").exists() else {}
        runs = sorted(set(precursors.get("raw.name", np.array([])).tolist()))
        log(
            f"[15c] {contract}: exits {r0['exit']} / {r1['exit']}; rank 0 searched {r0.get('searched')} on "
            f"{r0.get('devices')} in {r0.get('wall', float('nan')):.4f} s ({r0.get('launches')} launches, built the "
            f"outputs {r0.get('builds')} times), rank 1 searched {r1.get('searched')} on {r1.get('devices')} in "
            f"{r1.get('wall', float('nan')):.4f} s ({r1.get('launches')} launches, built {r1.get('builds')} times, outputs "
            f"there at its return: {r1.get('built_at_return')}); the whole {wall:.4f} s against [9]'s one process "
            f"{secs.get('cli', float('nan')):.4f} s; stat.tsv {len(stat['run'])} rows, precursors.parquet runs {runs} "
            f"({name}, {card})"
        )
        checks = [
            ("exit rank 0", r0["exit"], (0, 0)), ("exit rank 1", r1["exit"], (0, 0)),
            ("group size rank 0", r0.get("count", 0), (2, 2)), ("group size rank 1", r1.get("count", 0), (2, 2)),
            ("rank 0 searched run_0 only", int(r0.get("searched") == ["run_0"]), (1, 1)),
            ("rank 1 searched run_1 only", int(r1.get("searched") == ["run_1"]), (1, 1)),
            ("outputs built by rank 0", r0.get("builds", 0), (1, 1)), ("outputs built by rank 1", r1.get("builds", 1), (0, 0)),
            ("outputs there at rank 1's return", int(bool(r1.get("built_at_return"))), (1, 1)),
            ("launches rank 0", r0.get("launches", 0), (1, float("inf"))),
            ("launches rank 1", r1.get("launches", 0), (1, float("inf"))),
            ("stat.tsv rows", len(stat["run"]), (2, 2)), ("runs in precursors.parquet", len(runs), (2, 2)),
        ]
        if r0["exit"] == 0 and r1["exit"] == 0:
            checks += cli_id_checks(cli_readings(out, truth, cycle_rts))
            for run in ("run_0", "run_1"):
                one = read_parquet(tmp / "cli_out" / "quant" / run / "psm.parquet")
                two = read_parquet(out / "quant" / run / "psm.parquet")
                log(f"[15c] {contract} {run}: psm.parquet against [9]'s one-process CLI: {psm_differences(one, two)}")
        failed = [k for k, v, (lo, hi) in checks if not lo <= v <= hi]
        for k, v, (lo, hi) in checks:
            log(f"[15c] gate {contract} {k}: {v} in [{lo}, {hi}] {'ok' if lo <= v <= hi else 'FAILED'} ({name}, {card})")
        if failed:
            raise AssertionError(f"[15c] {contract}: gates failed: {failed}")


def phase15d(root, cli_inputs, name, card, tmp):
    """(d) ``general.fail_fast`` with rank 1's raw file unreadable: both
    processes end within the timeout, rank 1 with the exit code one process
    gives for that file, after rank 0 has built the outputs of its run."""
    import alphadia_torch.cli as cli

    raws, lib, _, _ = cli_inputs
    bad = tmp / "p15_unreadable.mzML"
    bad.write_text("<mzML>not a run</mzML>\n")
    cfg = json.dumps({"general": {"random_state": 0, "fail_fast": True, "log_level": "PROGRESS"}})
    expected = 0
    try:
        cli.run(["-o", str(tmp / "p15_ff_one"), "-f", str(bad), "-l", str(lib), "--config-dict", cfg])
    except SystemExit as e:
        expected = e.code
    out = tmp / "p15_ff"
    argv = ["-o", str(out), "-f", str(raws[0]), "-f", str(bad), "-l", str(lib), "--quant-dir", str(out / "quant"),
            "--config-dict", cfg]
    (r0, r1), wall = run_group(root, argv, "torchrun", tmp, "fail_fast")
    log(f"[15d] fail_fast, rank 1's file unreadable: exits {r0['exit']} / {r1['exit']} (one process on that file: "
        f"{expected}), rank 0 searched {r0.get('searched')}, rank 1's outputs there when it raised: "
        f"{r1.get('built_at_return')}; the whole {wall:.4f} s ({name}, {card})")
    checks = [("one process's exit on the file", expected, (1, float("inf"))), ("exit rank 0", r0["exit"], (0, 0)),
              ("exit rank 1", r1["exit"], (expected, expected)),
              ("rank 1 raised after the outputs", int(bool(r1.get("built_at_return"))), (1, 1))]
    failed = [k for k, v, (lo, hi) in checks if not lo <= v <= hi]
    for k, v, (lo, hi) in checks:
        log(f"[15d] gate {k}: {v} in [{lo}, {hi}] {'ok' if lo <= v <= hi else 'FAILED'} ({name}, {card})")
    if failed:
        raise AssertionError(f"[15d] gates failed: {failed}")


# ---------------------------------------------------------------------------
# phase [16]: figures and the GUI
# ---------------------------------------------------------------------------
FDR_FIGURES = {"calls": []}  # phase [9]'s fdr.png calls: (run, seconds); its output folder and walls
DEBUG_CANDIDATES = 8
GUI_DONE_S = 300.0
FIGURE_COLOUR_TOL = 6  # per channel, 0-255: a line's fully covered pixels


def blended(color, alpha) -> np.ndarray:
    """The RGB (0-255) of ``color`` drawn at ``alpha`` over white."""
    from alphadia_torch.reporting.figure import to_rgb

    return (np.asarray(to_rgb(color)) * alpha + (1.0 - alpha)) * 255.0


def colour_pixels(img, color, alpha=1.0) -> int:
    return int((np.abs(img[..., :3].astype(np.float64) - blended(color, alpha)).max(axis=2) <= FIGURE_COLOUR_TOL).sum())


def check_png(path, shape, colours, what) -> dict:
    """Read a figure back with the port's reader: its pixel size and, per
    (colour, alpha), the count of pixels drawn in it (at least 5 each)."""
    from alphadia_torch.utils.png import read_png

    img = read_png(path)
    if img.shape != shape:
        raise AssertionError(f"{what}: {path.name} is {img.shape}, expected {shape}")
    counts = {f"{c}@{a}": colour_pixels(img, c, a) for c, a in colours}
    missing = [k for k, v in counts.items() if v < 5]
    if missing:
        raise AssertionError(f"{what}: {path.name} lacks the colours {missing} ({counts})")
    return counts


def phase16a(worlds, name, card, launches, tmp):
    """The kernel debug plots on the card: the port's selection and scoring
    drivers on the 3D world, ``debug_candidates`` on the best candidates of
    the first ``DEBUG_CANDIDATES`` detectable targets (the kernel's launches
    counted and each held against the plain version), its PNGs and
    ``plot_dia_cycle`` of both worlds read back at their pixel sizes with
    their series' colours; the milliseconds per figure."""
    import torch

    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.reporting.figure import TAB10
    from alphadia_torch.reporting.reporting import FigureBackend
    from alphadia_torch.search import plotting
    from alphadia_torch.search.scoring import CandidateScoring, ScoringConfig

    dia, prec, frag = worlds[""]
    cands = select(dia, prec, frag, DEVICE, 60.0)
    targets = prec["precursor_idx"][prec["_truth_detectable"] & (prec["decoy"] == 0)]
    pick = (cands["rank"] == 0) & np.isin(cands["precursor_idx"], targets)
    best = {k: v[pick] for k, v in cands.items()}
    scoring = CandidateScoring(dia, prec, frag, ScoringConfig(), device=DEVICE)
    out = tmp / "debug_figures"
    with Recorder() as rec, MethodTimes([(FigureBackend, "log_figure", "figures"),
                                         (plotting, "debug_dense", "extraction")]) as mt:
        rec.stage = "debug_figures"
        torch.cuda.synchronize()
        xic_cuda.launches = 0
        t0 = time.perf_counter()
        names = plotting.debug_candidates(scoring, best, n=DEBUG_CANDIDATES, figure_dir=out)
        wall = time.perf_counter() - t0
        n_launch = xic_cuda.launches
    launches["debug_figures"] = n_launch
    if n_launch != 2 or len(rec.calls) != 2:
        raise AssertionError(f"[16a] debug_candidates: {n_launch} launches counted, {len(rec.calls)} recorded, 2 expected")
    worst, _ = all_launches_against_plain("[16a]", "debug figures", rec.calls)
    if len(names) != 2 * DEBUG_CANDIDATES or len(set(names)) != len(names):
        raise AssertionError(f"[16a] {len(names)} figure names, {len(set(names))} distinct")
    dense = plotting.debug_dense(scoring, {k: v[:DEBUG_CANDIDATES] for k, v in best.items()})
    O2, KI = dense["fragments"].shape[2], dense["isotopes"].shape[1]
    for i, pid in enumerate(best["precursor_idx"][:DEBUG_CANDIDATES].tolist()):
        colours = [(TAB10[0], 0.8)] + ([("k", 1.0)] if dense["template"][i].max() > 0 else [])
        check_png(out / f"debug_{pid}_fragments.png", (480, 600 * O2, 4), colours, "[16a]")
        check_png(out / f"debug_{pid}_precursor.png", (480, 675, 4), [(TAB10[k], 1.0) for k in range(KI)], "[16a]")
    n_fig = len(names)
    log(
        f"[16a] debug_candidates(n={DEBUG_CANDIDATES}) on the card: {n_fig} PNGs read back at 480 x {600 * O2} and "
        f"480 x 675 with their colours; {n_launch} kernel launches (B={DEBUG_CANDIDATES}, each held against the plain "
        f"version: max_abs={worst[0]:.3g}); wall {wall * 1e3:.2f} ms: extraction {mt.seconds['extraction'] * 1e3:.2f} ms, "
        f"drawing and writing {mt.seconds['figures'] * 1e3 / n_fig:.2f} ms a figure ({name}, {card})"
    )
    for label, tag in (("3D", ""), ("4D", "_4d")):
        d = worlds[tag][0]
        t0 = time.perf_counter()
        fig = plotting.plot_dia_cycle(d)
        fig.savefig(out / f"dia_cycle{tag}.png", dpi=150)
        ms = (time.perf_counter() - t0) * 1e3
        colours = [("#4878d0", 0.7)] + ([("#999", 0.25)] if (d.cycle[0, :, 0, 0] < 0).any() else [])
        counts = check_png(out / f"dia_cycle{tag}.png", (450, 1050, 4), colours, "[16a]")
        log(f"[16a] plot_dia_cycle {label}: {d.n_slots} slots, 450 x 1050 read back, colour pixels {counts}, "
            f"{ms:.2f} ms ({name}, {card})")
    return worst


def phase16b(name, card):
    """Each run's ``fdr.png`` of phase [9] (``save_figures`` at its default,
    true) read back at 1080 x 420 with the target and decoy colours; the
    calls of ``_plot_fdr`` a run, their milliseconds, and their share of
    the run's wall and of the CLI's."""
    from alphadia_torch.reporting.figure import TAB10

    calls = FDR_FIGURES["calls"]
    out = FDR_FIGURES["out"]
    for r, run_wall in enumerate(FDR_FIGURES["run_walls"]):
        ms = np.array([s for run, s in calls if run == r]) * 1e3
        if not ms.size:
            raise AssertionError(f"[16b] run_{r}: no fdr.png was drawn")
        counts = check_png(out / "quant" / f"run_{r}" / "figures" / "fdr.png", (420, 1080, 4),
                           [(TAB10[0], 1.0), (TAB10[1], 1.0)], "[16b]")
        log(
            f"[16b] run_{r}: fdr.png drawn {ms.size} times (one a FDR fit), {ms.mean():.2f} ms a call (min "
            f"{ms.min():.2f}, max {ms.max():.2f}), {ms.sum() / 1e3:.4f} s = {ms.sum() / 1e3 / run_wall:.4f} of the run's "
            f"wall {run_wall:.4f} s; read back 1080 x 420, target / decoy pixels {list(counts.values())} ({name}, {card})"
        )
    total = sum(s for _, s in calls)
    log(f"[16b] the figures' share of [9]'s CLI wall: {total:.4f} s of {FDR_FIGURES['cli_wall']:.4f} s = "
        f"{total / FDR_FIGURES['cli_wall']:.4f} ({len(calls)} figures) ({name}, {card})")


def phase16c(root, cli_inputs, name, card, tmp):
    """The port's GUI server on a loopback port in a thread: the token and
    Host checks, the schema, browse; a search of [9]'s run 0 launched
    through ``/api/run`` (a process of its own, on the card) until ``done``,
    its results and ``fdr.png`` served; a second run cancelled."""
    import secrets
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer
    from threading import Thread

    from alphadia_torch.gui.server import JobManager, make_handler
    from alphadia_torch.utils.parquet import read_parquet

    raws, lib, _, _ = cli_inputs
    saved = {k: os.environ.get(k) for k in ("ALPHADIA_TPU_CACHE", "PYTHONPATH", "ALPHADIA_TORCH_DEVICE")}
    os.environ["ALPHADIA_TPU_CACHE"] = str(tmp / "gui_cache")
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (str(root), saved["PYTHONPATH"]) if p)
    os.environ.pop("ALPHADIA_TORCH_DEVICE", None)  # the child runs on the card
    token = secrets.token_urlsafe(16)
    jobs = JobManager()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(jobs, token))
    Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, payload=None, tok=token, host=None, raw=False):
        headers = {"X-Auth-Token": tok, **({"Host": host} if host else {})}
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(base + path, data=data, headers=headers, method="GET" if data is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                body = r.read()
                return r.status, body if raw else json.loads(body)
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def wait(states, seconds):
        t0 = time.perf_counter()
        st = {}
        while time.perf_counter() - t0 < seconds:
            st = call("/api/status")[1]
            if st["state"] in states:
                break
            time.sleep(0.5)
        return st, time.perf_counter() - t0

    try:
        checks = {
            "wrong token 403": call("/api/schema", tok="wrong")[0] == 403,
            "foreign Host 403": call("/api/schema", host="evil.example:8855")[0] == 403,
        }
        schema = call("/api/schema")[1]
        n_params = sum(len(s["parameters"]) for s in schema["config"])
        checks["schema > 80 parameters"] = n_params > 80
        entries = {e["name"]: e for e in call(f"/api/browse?path={raws[0].parent}")[1]["entries"]}
        checks["browse marks .mzML raw"] = entries[raws[0].name]["raw"]
        out = tmp / "gui_out"
        payload = {"raw_path_list": [str(raws[0])], "library": str(lib), "output_directory": str(out),
                   "config": {"general": {"random_state": 0}}}
        code, res = call("/api/run", payload)
        if code != 200:
            raise AssertionError(f"[16c] /api/run: {code} {res}")
        st, run_wall = wait(("done", "failed", "cancelled"), GUI_DONE_S)
        if st.get("state") != "done":
            raise AssertionError(f"[16c] the GUI's search ended {st.get('state')}: {st.get('log_tail', '')[-3000:]}")
        results = call("/api/results?output=" + str(out))[1]
        prec = read_parquet(out / "precursors.parquet")
        fdr_png = out / "quant" / raws[0].stem / "figures" / "fdr.png"
        checks["summary.precursors = rows of precursors.parquet"] = (
            results["summary"]["precursors"] == len(next(iter(prec.values()))) > 0)
        checks["figures lists fdr.png"] = str(fdr_png) in results["figures"]
        code, body = call("/api/figure?path=" + str(fdr_png), raw=True)
        checks["/api/figure serves fdr.png byte for byte"] = code == 200 and body == fdr_png.read_bytes()
        checks["a path outside the history 403"] = call("/api/figure?path=" + str(FDR_FIGURES["out"] / "quant" / "run_0" / "figures" / "fdr.png"))[0] == 403
        code, res = call("/api/run", {**payload, "output_directory": str(tmp / "gui_out2")})
        time.sleep(2.0)
        code_c, res_c = call("/api/cancel", {})
        st2, cancel_wall = wait(("done", "failed", "cancelled"), 60.0)
        checks["a cancelled run ends cancelled"] = code == 200 and code_c == 200 and st2.get("state") == "cancelled"
        failed = [k for k, ok in checks.items() if not ok]
        log(
            f"[16c] GUI on {base}: {n_params} parameters; the search of {raws[0].name} through /api/run (a process on "
            f"the card) done in {run_wall:.2f} s, {results['summary']['precursors']} precursors, {len(results['figures'])} "
            f"figures listed; the second run cancelled after 2 s, ended {st2.get('state')} {cancel_wall:.2f} s later; "
            f"checks {json.dumps(checks)} ({name}, {card})"
        )
        if failed:
            raise AssertionError(f"[16c] GUI checks failed: {failed}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        if jobs._proc is not None and jobs._proc.poll() is None:
            jobs.cancel()
            jobs._proc.wait(timeout=60)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---- phase [17]: the peak-store builder and the two trainers ----------------
# [17a] the C++ builder (csrc/peakstore.cpp) against its numpy version on the
# two worlds and [8]'s 4D quarter world, on 1 and on every host thread; then
# alone on a run of PS_RUN_PEAKS peaks (the 3D world tiled in RT, as [12b]
# tiles it). The numpy builder runs at that size only if a probe at a
# twentieth says it fits PS_NUMPY_BUDGET_S; else at the largest size that does
# (the script's time: at 15 s the script took 1,178 s of its 1,200 on a slow
# host)
PS_RUN_PEAKS = 50_000_000
PS_NUMPY_BUDGET_S = 5.0
PS_STORE = ("peak_mz", "peak_intensity", "peak_is_ghost", "peak_scanbin", "cell_start")
# [17b] the default-classifier trainer at its full corpora (600 peptides a
# corpus). JAX's helpers on the CPU read (`JAX_PLATFORMS=cpu PYTHONPATH=.
# python tests/test_torch_train_default_classifier.py`) the readings below;
# the port's trainer on the CPU at classifier random states 0-5 (`... --port
# --device cpu`, the corpora searched once) the rows of CLS_PORT_STATES,
# whose spread (largest less least) is each reading's margin: on the card
# each reading lies within its margin of JAX's, and the warm-start gate
# passes. State 4's cold fit of corpus 113 collapsed (54 IDs), so that
# reading's margin is wide
CLS_FILE = "ea4b0fe1c1f77109.pkl"
CLS_JAX_READINGS = {"separation": 0.6929035186767578, "warm_101": 417, "cold_101": 418, "warm_113": 519,
                    "cold_113": 515}
CLS_PORT_STATES = [  # random states 0 to 5
    {"separation": 0.6927189230918884, "warm_101": 417, "cold_101": 418, "warm_113": 518, "cold_113": 515},
    {"separation": 0.6981293559074402, "warm_101": 423, "cold_101": 417, "warm_113": 515, "cold_113": 515},
    {"separation": 0.7061959505081177, "warm_101": 414, "cold_101": 423, "warm_113": 515, "cold_113": 514},
    {"separation": 0.7042240500450134, "warm_101": 416, "cold_101": 410, "warm_113": 519, "cold_113": 517},
    {"separation": 0.6745747327804565, "warm_101": 411, "cold_101": 395, "warm_113": 524, "cold_113": 54},
    {"separation": 0.6983124017715454, "warm_101": 410, "cold_101": 419, "warm_113": 518, "cold_113": 515},
]
CLS_MARGIN = {k: max(r[k] for r in CLS_PORT_STATES) - min(r[k] for r in CLS_PORT_STATES) for k in CLS_JAX_READINGS}
# [17c] the property-model trainer at the shipped widths, cut for the
# script's time: a third of the corpus (4,000 sequences a world, 7,000 for
# MS2 and CCS, 1,000 held-out draws) and 20 of the 80 epochs. JAX's helpers
# at the same cut on the CPU (`JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/test_torch_train_property_models.py --jax`) read PM_JAX_READINGS;
# each of PM_GATES (R^2, Pearson r, Spearman rho, angles, shares) of the
# card's run lies at most PM_MARGIN below JAX's. The port's trainer at the
# same cut on the CPU (`... --device cpu`) read within 0.011 of JAX's (the
# mobility model's mass correlations, 0.646 / 0.640 against 0.657 / 0.651:
# at 20 epochs it is far from converged and rounding moves it), so the
# cut's margin is 0.03; the full run is held to 0.01 (R^2, rho) and 0.02
# (angles). The full run (80 epochs, all three worlds) is a command of its
# own (`python -m alphadia_torch.scripts.train_property_models --out DIR`)
PM_CUT = dict(sequences_per_world=4000, ms2_subset=7000, eval_sequences=1000, epochs=20)
PM_JAX_READINGS = {
    "rt_r2": 0.9688661694526672, "charge_accuracy": 0.9535555555555556, "ms2_sa": 0.7085419297218323,
    "ccs_r2": 0.604531466960907, "epochs": [20, 20, 20, 20], "holdout_rt_r2": 0.9630296230316162,
    "holdout_ms2_sa": 0.7098392248153687, "cross_rt_r2": 0.9651969075202942, "cross_ms2_sa": 0.7069803476333618,
    "krokhin_spearman": 0.9882551618101736, "ccs_mass_corr_z2": 0.6565071004540577,
    "ccs_mass_corr_z3": 0.6506856494144281, "charge_frac_top_2_or_3": 0.963,
    "charge_basic_spearman": 0.9594399212258068,
}
PM_MARGIN = 0.03
PM_GATES = (
    "rt_r2", "ccs_r2", "holdout_rt_r2", "cross_rt_r2", "krokhin_spearman", "ccs_mass_corr_z2", "ccs_mass_corr_z3",
    "charge_basic_spearman", "charge_accuracy", "ms2_sa", "holdout_ms2_sa", "cross_ms2_sa", "charge_frac_top_2_or_3",
)


class BuilderCalls:
    """Times ``DiaData``'s two peak-store builders where it calls them and
    gives the C++ one ``threads`` (None: its default)."""

    def __init__(self, threads=None):
        self.threads, self.calls = threads, []

    def __enter__(self):
        from alphadia_torch.rawdata import diadata

        self.module = diadata
        self.original = (diadata.build_peak_store, diadata.build_peak_store_numpy)

        def timed(fn, **extra):
            def call(*args, **kw):
                t0 = time.perf_counter()
                out = fn(*args, **kw, **extra)
                self.calls.append(time.perf_counter() - t0)
                return out

            return call

        diadata.build_peak_store = timed(self.original[0], threads=self.threads)
        diadata.build_peak_store_numpy = timed(self.original[1])
        return self

    def __exit__(self, *exc):
        self.module.build_peak_store, self.module.build_peak_store_numpy = self.original

    @property
    def seconds(self) -> float:
        (seconds,) = self.calls
        return seconds


def same_store(a, b) -> bool:
    return all(
        getattr(a, f).dtype == getattr(b, f).dtype and getattr(a, f).shape == getattr(b, f).shape
        and getattr(a, f).tobytes() == getattr(b, f).tobytes()
        for f in PS_STORE
    )


def built(spectra, threads=None, use_native=True):
    """(DiaData, the builder's seconds) of ``spectra``."""
    from alphadia_torch.rawdata import DiaData

    with BuilderCalls(threads) as calls:
        dia = DiaData.from_spectra(spectra, n_scan_bins=N_SCAN_BINS, use_native=use_native)
    return dia, calls.seconds


def phase17a(spectra, name, card):
    """The C++ builder against the numpy builder (every array equal, at 1
    and N threads) on the worlds, then alone on a run of PS_RUN_PEAKS peaks;
    the walls of both, their thread counts and peaks per second."""
    threads = os.cpu_count() or 1
    t_phase = time.perf_counter()
    for label, tag in (("3D", ""), ("4D", "_4d"), ("4D quarter", "_4d_quarter")):
        sp = spectra[tag]
        plain, s_np = built(sp, use_native=False)
        walls = {}
        for t in sorted({1, threads}):
            dia, walls[t] = built(sp, t)
            if not same_store(dia, plain):
                raise AssertionError(f"[17a] {label}: the C++ builder on {t} thread(s) differs from the numpy builder")
        n = len(sp.mz)
        log(
            f"[17a] {label} world: {n} peaks, {plain.n_stored_peaks} stored, {plain.cell_start.size} cell offsets; "
            f"every array equal at atol 0 on 1 and {threads} threads; numpy builder {s_np:.4f} s (one thread, "
            f"{n / s_np:.0f} peaks/s); C++ builder " + ", ".join(
                f"{walls[t]:.4f} s on {t} thread(s) ({n / walls[t]:.0f} peaks/s)" for t in sorted(walls))
            + f"; {s_np / walls[threads]:.2f} times faster on {threads} (host of {name}, {card})"
        )
    base = spectra[""]
    probe = tiled_run(base, PS_RUN_PEAKS // 20)
    _, s_probe = built(probe, use_native=False)
    rate = len(probe.mz) / s_probe
    n_numpy = min(PS_RUN_PEAKS, int(rate * PS_NUMPY_BUDGET_S))
    del probe
    run = tiled_run(base, PS_RUN_PEAKS)
    t0 = time.perf_counter()
    dia, s_cpp = built(run)
    wall = time.perf_counter() - t0
    cells, stored = dia.cell_start.size, dia.n_stored_peaks
    del dia
    log(
        f"[17a] a run of {len(run.mz)} peaks ({run.n_spectra} spectra, the 3D world tiled in RT): C++ builder "
        f"{s_cpp:.4f} s on {threads} threads ({len(run.mz) / s_cpp:.0f} peaks/s), {stored} stored, {cells} cell "
        f"offsets; DiaData.from_spectra {wall:.4f} s in all (host of {name}, {card})"
    )
    del run
    log(
        f"[17a] numpy builder probe: {rate:.0f} peaks/s on a twentieth; at {PS_RUN_PEAKS} peaks it would take "
        f"{PS_RUN_PEAKS / rate:.1f} s against the {PS_NUMPY_BUDGET_S:.0f} s aim: "
        + ("the full run" if n_numpy == PS_RUN_PEAKS else f"the largest size that fits, {n_numpy} peaks")
    )
    run = tiled_run(base, n_numpy)
    plain, s_np = built(run, use_native=False)
    dia, s_cpp = built(run)
    if not same_store(dia, plain):
        raise AssertionError(f"[17a] the C++ builder differs from the numpy builder on {len(run.mz)} peaks")
    n = len(run.mz)
    log(
        f"[17a] {n} peaks: numpy builder {s_np:.4f} s ({n / s_np:.0f} peaks/s, one thread), C++ builder {s_cpp:.4f} s "
        f"({n / s_cpp:.0f} peaks/s, {threads} threads), every array equal at atol 0; {s_np / s_cpp:.2f} times faster; "
        f"phase [17a] {time.perf_counter() - t_phase:.2f} s (host of {name}, {card})"
    )


def phase17b(name, card, launches, tmp):
    """``train_default_classifier`` on the card at its full corpora: every XIC
    launch of its nine searches counted and held against the plain version;
    the file, its state read back, the warm-start gate and the readings
    against JAX's."""
    import pickle

    import torch

    from alphadia_torch.models.classifier import BinaryClassifier
    from alphadia_torch.ops import xic_cuda
    from alphadia_torch.scripts import train_default_classifier as tdc

    out = tmp / "classifier"
    with Recorder() as rec:
        rec.stage = "classifier_trainer"
        torch.cuda.synchronize()
        xic_cuda.launches = 0
        t0 = time.perf_counter()
        report = tdc.train(out, device=DEVICE)
        wall = time.perf_counter() - t0
        n_launch = xic_cuda.launches
    launches["classifier_trainer"] = n_launch
    if not n_launch or n_launch != len(rec.calls):
        raise AssertionError(f"[17b] {n_launch} launches counted, {len(rec.calls)} recorded")
    worst, _ = all_launches_against_plain("[17b]", "classifier trainer", rec.calls)
    del rec
    if not report["passed"]:
        raise AssertionError(f"[17b] the warm start loses IDs on the held-out corpora: gains {report['gains']}")
    if report["path"] is None or report["path"].name != CLS_FILE:
        raise AssertionError(f"[17b] the trainer wrote {report['path']}, not {CLS_FILE}")
    state = pickle.loads(report["path"].read_bytes())
    clf = BinaryClassifier.from_state_dict(state, DEVICE)
    x = np.random.default_rng(0).normal(0, 1, (256, state["input_dim"])).astype(np.float32)
    p_back = clf.predict_proba(x)
    p_live = BinaryClassifier.from_state_dict(report["state"], DEVICE).predict_proba(x)
    if not np.isfinite(p_back).all() or not np.array_equal(p_back, p_live):
        raise AssertionError("[17b] the written state does not predict what the trained one predicts")
    got = {"separation": report["separation"]}
    for seed, (warm, cold) in report["eval"].items():
        got[f"warm_{seed}"], got[f"cold_{seed}"] = warm, cold
    off = {k: got[k] - CLS_JAX_READINGS[k] for k in CLS_JAX_READINGS}
    log(
        f"[17b] train_default_classifier on the card: {report['n_psms']} PSMs ({report['n_decoys']} decoys) from 7 "
        f"corpora, {n_launch} kernel launches in its 9 searches, each held against the plain version (max_abs="
        f"{worst[0]:.3g}); separation {got['separation']:.4f}; held-out warm / cold IDs at 1% FDR "
        + ", ".join(f"{seed}: {w} / {c}" for seed, (w, c) in report["eval"].items())
        + f", gains {report['gains']}; {report['path'].name} written and read back; wall {wall:.2f} s; against "
        f"JAX's readings {json.dumps(CLS_JAX_READINGS)}: {json.dumps(off)}, margins {json.dumps(CLS_MARGIN)} "
        f"({name}, {card})"
    )
    bad = [k for k in CLS_JAX_READINGS if abs(off[k]) > CLS_MARGIN[k]]
    if bad:
        raise AssertionError(f"[17b] readings outside their margin of JAX's: {bad}")
    return worst


def phase17c(name, card):
    """``train_property_models`` on the card at PM_CUT: the walls, epochs,
    steps and ms a step of each fit, and every reading against JAX's at the
    same cut."""
    from alphadia_torch.scripts import train_property_models as tpm

    t0 = time.perf_counter()
    r = tpm.train(device=DEVICE, write=False, **PM_CUT)
    wall = time.perf_counter() - t0
    got = tpm.summary(r["mgr"].metrics, r["within"], r["cross"], r["pub"])
    for model, f in r["fits"].items():
        log(f"[17c] {model}: {f['epochs']} epochs, {f['steps']} steps, {f['seconds']:.2f} s, "
            f"{f['seconds'] / max(f['steps'], 1) * 1e3:.2f} ms a step ({name}, {card})")
    off = {k: got[k] - PM_JAX_READINGS[k] for k in PM_GATES}
    log(
        f"[17c] train_property_models on the card at {json.dumps(PM_CUT)}: wall {wall:.2f} s; readings "
        f"{json.dumps(got)}; less JAX's at the same cut {json.dumps(off)}; the packaging bars "
        f"{'pass' if r['passed'] else 'do not pass'} at this cut ({name}, {card})"
    )
    bad = [k for k in PM_GATES if off[k] < -PM_MARGIN]
    if bad:
        raise AssertionError(f"[17c] readings more than their margin below JAX's: {bad}")


# ---------------------------------------------------------------------------
# 5b. the scan-resolved kernel alone at the 4D benchmark cell's shapes
# ---------------------------------------------------------------------------
# perfbench's timstof4d cell: 8 scan bins, 1-Th rows, 700 cycles, selection
# windows of 128 cycles read through a 4,096-peak slab, batches of 2,048;
# a row holds ~2,000 stored peaks over such a window (13 a cell here), and
# the store has 4 of the cell's 32 slots, so its ~44 M rows fit beside the
# plain version's ~38 GB
CELL_4D = dict(n_slots=4, n_bins=1200, bin_mz_min=200.0, n_cycles=700, peaks_per_cell=13.0, n_scan_bins=8,
               slab=4096, batch=2048, window=128, score_window=32, profile_cycles=12, masked=0.4)


def scan_cells_store(seed=20):
    """A peak store at ``CELL_4D``'s density on the card, sorted by (slot,
    bin, cycle, m/z), and its int32 ``cell_start``."""
    import torch

    from alphadia_torch.rawdata.diadata import PeakStore

    c = CELL_4D
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n_rows, C = c["n_slots"] * c["n_bins"], c["n_cycles"]
    counts = torch.poisson(torch.full((n_rows * C,), c["peaks_per_cell"], device=DEVICE), generator=g).long()
    starts = torch.zeros(n_rows * C + 1, dtype=torch.long, device=DEVICE)
    starts[1:] = torch.cumsum(counts, 0)
    n = int(starts[-1])
    idx = torch.arange(n_rows, device=DEVICE)[:, None] * C + torch.arange(C + 1, device=DEVICE)
    cell_start = starts[idx].to(torch.int32).reshape(c["n_slots"], c["n_bins"], C + 1)
    cell = torch.repeat_interleave(torch.arange(n_rows * C, device=DEVICE), counts)
    u = torch.rand(n, generator=g, device=DEVICE, dtype=torch.float64)
    order = torch.argsort(cell.double() + u)  # each cell's peaks by m/z
    bin_of = (cell // C) % c["n_bins"]
    n_pad = -(-n // 8) * 8
    packed = torch.zeros((n_pad, 2), dtype=torch.float32, device=DEVICE)
    packed[:n, 0] = (c["bin_mz_min"] + bin_of + u[order]).float()
    packed[n:, 0] = float("inf")
    packed[:n, 1] = torch.exp(8.0 + 1.5 * torch.randn(n, generator=g, device=DEVICE))
    scanbin = torch.zeros(n_pad, dtype=torch.int16, device=DEVICE)
    scanbin[:n] = torch.randint(0, c["n_scan_bins"], (n,), generator=g, device=DEVICE).to(torch.int16)
    cycle = torch.zeros(n_pad, dtype=torch.int16, device=DEVICE).view(torch.uint16)
    return PeakStore(packed, cycle, scanbin), cell_start


def scan_cells_queries(store, cell_start, Q, seed):
    """[B, Q] queries of ``CELL_4D``'s batch: each at a stored peak's m/z in
    a random slot, ``masked`` of them -1, at a window start that keeps the
    window inside the run."""
    import torch

    c = CELL_4D
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    B, C = c["batch"], c["n_cycles"]
    pick = torch.randint(0, int(cell_start.reshape(-1)[-1]), (B, Q), generator=g, device=DEVICE)
    qmz = store.packed[pick, 0].contiguous()
    slot = torch.randint(0, c["n_slots"], (B, Q), generator=g, device=DEVICE).to(torch.int32)
    slot[torch.rand((B, Q), generator=g, device=DEVICE) < c["masked"]] = -1
    c0 = torch.randint(0, C - c["window"], (B,), generator=g, device=DEVICE).to(torch.int32)
    return slot, qmz, c0


def scan_cells_work(cell_start, slot, qmz, lo, hi, kw, planes) -> int:
    """Bytes one launch must move: each peak that some query's slab covers
    once (m/z, intensity and scan bin, 10 B), each valid query's W+1 window
    edges (4 B), the queries, and every output plane once."""
    import torch

    from alphadia_torch.ops.xic import query_rows

    L = cell_start.shape[2]
    row = query_rows(slot, qmz, n_slots=cell_start.shape[0], n_bins=kw["n_bins"], bin_mz_min=kw["bin_mz_min"],
                     bin_width=kw["bin_width"])
    flat = cell_start.reshape(-1).long()
    r0 = flat[row * L + lo.long().clamp(0, kw["n_cycles"])[:, None]]
    length = torch.where(slot >= 0, (flat[row * L + hi.long().clamp(0, kw["n_cycles"])[:, None]] - r0).clamp(0, kw["slab"]), 0)
    edge = torch.zeros(int(flat.max()) + 1, dtype=torch.int32, device=slot.device)
    live = length > 0
    edge.index_add_(0, r0[live], torch.ones_like(r0[live], dtype=torch.int32))
    edge.index_add_(0, (r0 + length)[live], -torch.ones_like(r0[live], dtype=torch.int32))
    peaks = int((torch.cumsum(edge, 0)[:-1] > 0).sum())
    B, Q = slot.shape
    W = kw.get("window_len", 1)
    return peaks * 10 + int((slot >= 0).sum()) * (W + 1) * 4 + B * Q * 8 + B * 8 + planes * B * Q * kw["n_scan_bins"] * W * 4


def phase5b(name, card) -> dict:
    """The scan-resolved kernel (``ops/scan_cells_cuda``) alone on a store at
    the 4D cell's density and its launch shapes: selection's fragment (Q 24)
    and isotope (Q 3) XICs over 128 cycles, scoring's precursor cells with
    the m/z plane (Q 3, W 32) and its scan profiles (Q 24 and 3). Per launch
    the device ms warm and L2-flushed, the bound (bytes at 3.35 TB/s), the
    plain version's ms and peak memory; each launch held to the plain version
    at the card tests' tolerance. Returns the ``scan_cells`` entry's numbers."""
    import torch

    from alphadia_torch.ops import scan_cells_cuda
    from alphadia_torch.ops.xic import extract_scan_profile, extract_xic_4d

    t0 = time.perf_counter()
    c = CELL_4D
    store, cs = scan_cells_store()
    base = dict(n_cycles=c["n_cycles"], n_bins=c["n_bins"], bin_mz_min=c["bin_mz_min"], bin_width=1.0,
                n_scan_bins=c["n_scan_bins"], slab=c["slab"])
    log(f"[5b] store at the 4D cell's density: {store.packed.shape[0]} rows, {c['n_slots']} slots x {c['n_bins']} "
        f"bins x {c['n_cycles']} cycles, made in {time.perf_counter() - t0:.2f} s ({name}, {card})")
    launches = []
    for label, Q, tol, mode, W, with_mz in (
        ("selection frag", 24, 10.0, "cells", c["window"], False),
        ("selection iso", 3, 5.0, "cells", c["window"], False),
        ("scoring prec cells", 3, 5.0, "cells", c["score_window"], True),
        ("scoring frag profile", 24, 10.0, "profile", 1, False),
        ("scoring prec profile", 3, 5.0, "profile", 1, False),
    ):
        slot, qmz, c0 = scan_cells_queries(store, cs, Q, seed=len(launches))
        if mode == "cells":
            kw = dict(base, window_len=W, with_mz=with_mz)
            args = (store, cs, slot, qmz, tol, c0)
            lo, hi = c0, c0 + W
            kernel = functools.partial(scan_cells_cuda.extract_xic_4d_cuda, *args, **kw)
            plain = functools.partial(extract_xic_4d, store.packed[:, 0], store.packed[:, 1], store.scanbin,
                                      cs, slot, qmz, tol, c0, **kw)
        else:
            lo, hi = c0 + c["window"] // 2, c0 + c["window"] // 2 + c["profile_cycles"]
            args = (store, cs, slot, qmz, tol, lo, hi)
            kernel = functools.partial(scan_cells_cuda.extract_scan_profile_cuda, *args, **base)
            plain = functools.partial(extract_scan_profile, store.packed[:, 0], store.packed[:, 1], store.scanbin,
                                      cs, slot, qmz, tol, lo, hi, **base)
            kw = base
        launches.append((label, kernel, plain, scan_cells_work(cs, slot, qmz, lo, hi, kw, 2 if with_mz else 1)))
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    tot = dict(ms=0.0, flushed_ms=0.0, plain_ms=0.0, bytes=0, max_abs_err=0.0)
    for label, kernel, plain, nbytes in launches:
        got, want = kernel(), plain()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, w, atol in zip(got, want, (0.0, 1e-9)):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=atol)
            tot["max_abs_err"] = max(tot["max_abs_err"], float((g - w).abs().max()))
        if not float(want[0].sum()) > 0:
            raise AssertionError(f"[5b] {label}: no peak matched")
        del got, want
        k_ms = device_ms(kernel, KERNEL_REPS)
        f_ms = device_ms_flushed(kernel, KERNEL_REPS, flush)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        p_ms = device_ms(plain, PLAIN_REPS, warmup=1)
        p_mem = torch.cuda.max_memory_allocated() - base_mem
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[5b] {label:20s} kernel {k_ms:.4f} ms (L2 flushed {f_ms:.4f}, {bound / f_ms:.3f} of bound), bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.2f} MB), plain {p_ms:.4f} ms (peak {p_mem / 2**30:.2f} GiB), "
            f"{p_ms / f_ms:.0f} times the kernel's ({name}, {card})")
        tot["ms"] += k_ms
        tot["flushed_ms"] += f_ms
        tot["plain_ms"] += p_ms
        tot["bytes"] += nbytes
    del flush, store, cs, launches
    torch.cuda.empty_cache()
    tot["bound_ms"] = tot["bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"[5b] the five launches: kernel {tot['flushed_ms']:.4f} ms L2-flushed ({tot['bound_ms'] / tot['flushed_ms']:.3f} "
        f"of bound), bound {tot['bound_ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms; max abs err "
        f"{tot['max_abs_err']:.3g}; phase [5b] took {time.perf_counter() - t0:.2f} s ({name}, {card})")
    return tot


# ---------------------------------------------------------------------------
# 18. a store past 2**31 entries: the int64 cell index
# ---------------------------------------------------------------------------
# rows of filler placed on the card before the recorded launches' stores in
# [18a], so that every cell offset of theirs lies past 2**31
INDEX64_FILLER = 2**31


def phase18a(calls, per_stage, name, card) -> dict:
    """(a) Every launch of phase [5] again with its store behind
    ``INDEX64_FILLER`` rows on the card and its cell index widened to int64
    and moved past 2**31: equal at atol 0 to the same launch with the int32
    index at offset 0, and held to the plain version at the same offset.
    Per pass the device ms of both instantiations (each pass timed in turns
    in this phase, beside phase [5]'s int32 ms), the plain version's at the
    offset and both bounds (the int64 one reads 8 B a window edge). Frees
    the store before it returns the numbers of the ``xic_index64`` entry."""
    import torch

    from alphadia_torch.testing.offset_store import behind_filler

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stores = {}
    for _, args, _ in calls:
        stores.setdefault(args[0].packed.data_ptr(), args[0])
    big, first = behind_filler(list(stores.values()), INDEX64_FILLER)
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in big) / 1e9
    log(
        f"[18a] {len(stores)} stores of the recorded launches behind {INDEX64_FILLER} filler rows: "
        f"{big.packed.shape[0]} rows, {gb:.2f} GB on the card (12 B a row), made on the card in "
        f"{time.perf_counter() - t0:.2f} s; their first rows {min(first)}-{max(first)} ({name}, {card})"
    )
    out = launches_past_2_31(calls, per_stage, big, dict(zip(stores, first)), name, card)
    del big
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[18a] store freed: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated after the phase, which took "
        f"{time.perf_counter() - t0:.2f} s")
    return out


def launches_past_2_31(calls, per_stage, big, at, name, card) -> dict:
    """[18a]'s checks and timings of ``calls`` on ``big``, each call's store
    at its first row ``at[data_ptr]``; holds no reference to ``big`` once it
    returns."""
    import functools

    import torch

    from alphadia_torch.ops.xic import extract_xic_packed
    from alphadia_torch.ops.xic_cuda import extract_xic_cuda

    passes, worst = {}, [0.0, 0.0]
    for i, (stage, args, kw) in enumerate(calls):
        store, cs, slot, qmz, tol, c0 = args
        args64 = (big, cs.long() + at[store.packed.data_ptr()], slot, qmz, tol, c0)
        want = extract_xic_cuda(*args, **kw)
        got = extract_xic_cuda(*args64, **kw)
        want, got = (x if isinstance(x, tuple) else (x,) for x in (want, got))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"[18a] {stage} launch {i}: the int64 index past 2**31 differs from the int32 index")
        for plane, (mabs, mrel, bad, _) in zip(("intensity", "mz"), plane_errors(got, extract_xic_packed(*args64, **kw), kw)):
            if bad:
                raise AssertionError(f"[18a] {stage} launch {i} {plane}: the int64 index disagrees with the plain version")
            worst = [max(worst[0], mabs), max(worst[1], mrel)]
        acc = passes.setdefault(stage, {"int32": [], "int64": [], "plain": [], "bytes32": 0, "bytes64": 0, "ops": 0})
        acc["int32"].append(functools.partial(extract_xic_cuda, *args, **kw))
        acc["int64"].append(functools.partial(extract_xic_cuda, *args64, **kw))
        acc["plain"].append(functools.partial(extract_xic_packed, *args64, **kw))
        b32, ops = work(args, kw)
        b64, _ = work((store, cs.long(), slot, qmz, tol, c0), kw)  # the same bytes as at the offset
        acc["bytes32"] += b32
        acc["bytes64"] += b64
        acc["ops"] += ops
    log(f"[18a] {len(calls)} launches at the offset, each equal to its int32 twin at atol 0 and within [3]'s tolerances "
        f"of the plain version: max_abs={worst[0]:.3g} max_rel={worst[1]:.3g} ({name}, {card})")

    def bound(nbytes, ops):
        return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3

    tot = dict.fromkeys(("int32", "int64", "plain", "bytes32", "bytes64", "ops", "phase5"), 0.0)
    for stage, acc in passes.items():
        ms32, ms64 = launches_ms(acc["int32"], reps=3), launches_ms(acc["int64"], reps=3)
        ms64_again, ms32_again = launches_ms(acc["int64"], reps=3), launches_ms(acc["int32"], reps=3)
        ms32, ms64 = (ms32 + ms32_again) / 2, (ms64 + ms64_again) / 2
        plain_ms = launches_ms(acc["plain"], reps=1)
        b32, b64 = bound(acc["bytes32"], acc["ops"]), bound(acc["bytes64"], acc["ops"])
        log(
            f"[18a] {stage:17s} {len(acc['int32'])} launches: int32 at offset 0 {ms32:.4f} ms (bound {b32:.4f}; phase "
            f"[5] {per_stage[stage]['ms']:.4f}), int64 past 2**31 {ms64:.4f} ms (bound {b64:.4f}), {ms64 / ms32:.3f} "
            f"times the int32 time; plain version at the offset {plain_ms:.4f} ms ({name}, {card})"
        )
        for k, v in (("int32", ms32), ("int64", ms64), ("plain", plain_ms), ("bytes32", acc["bytes32"]),
                     ("bytes64", acc["bytes64"]), ("ops", acc["ops"]), ("phase5", per_stage[stage]["ms"])):
            tot[k] += v
    by_bytes = tot["bytes64"] / HBM_BYTES_PER_S >= tot["ops"] / FP32_OPS_PER_S
    out = {
        "ms": tot["int64"], "plain_ms": tot["plain"], "bound_ms": bound(tot["bytes64"], tot["ops"]),
        "bound_by": "bytes" if by_bytes else "operations", "max_abs_err": worst[0],
    }
    log(
        f"[18a] these {len(calls)}: int32 at offset 0 {tot['int32']:.4f} ms (bound {bound(tot['bytes32'], tot['ops']):.4f}; "
        f"phase [5] {tot['phase5']:.4f}), int64 past 2**31 {tot['int64']:.4f} ms (bound {out['bound_ms']:.4f}, "
        f"{out['bound_by']}; {tot['bytes64'] - tot['bytes32']:.0f} B more than int32's), {tot['int64'] / tot['int32']:.3f} "
        f"times; plain at the offset {tot['plain']:.4f} ms ({name}, {card})"
    )
    return out


def phase18b(worlds, main_out, name, card) -> dict:
    """(b) Both main paths of phase [4] at full width from a ``DiaData``
    whose cell index is widened to int64 (the fine and the coarse view): the
    candidates of both selections equal to [4]'s int32 run, every PSM
    feature within ``FEATURE_REL_TOL`` of it; the kernel's launches per pass
    (the ``xic_index64`` entry's). Frees the views before it returns."""
    import dataclasses

    import torch

    launches = {}
    for label, tag, kernel_passes in (("3D", "", ("selection", "scoring", "selection_wide")), ("4D", "_4d", ("scoring",))):
        dia, prec, frag = worlds[tag]
        wide = dataclasses.replace(dia, cell_start=dia.cell_start.astype(np.int64), _device={})
        out, secs, n = main_path((wide, prec, frag), tag)
        views = [wide.device_arrays(stride, DEVICE)["cell_start"].dtype for stride in (1, 2)]
        ref = main_out[tag]
        same = {p: candidate_keys(out[p + tag]) == candidate_keys(ref[p + tag]) for p in ("selection", "selection_wide")}
        ka, kb, dev, equal, _, _ = paired_features(out["scoring" + tag][0], ref["scoring" + tag][0])
        log(
            f"[18b] {label} from the int64 index (views {views}): wall s " + ", ".join(f"{k} {v:.4f}" for k, v in secs.items())
            + f"; launches {json.dumps(n)}; candidates equal to [4]'s int32 run {same}; PSM keys {len(ka)} / {len(kb)} "
            f"identical {ka == kb}, feature values within {FEATURE_REL_TOL} {float(np.mean(dev <= FEATURE_REL_TOL)):.6f}, "
            f"bit-equal {float(np.mean(equal)):.6f} ({name}, {card})"
        )
        if views != [torch.int64, torch.int64]:
            raise AssertionError(f"[18b] {label}: a view of the int64 index is not int64")
        if not all(same.values()) or ka != kb or not (dev <= FEATURE_REL_TOL).all():
            raise AssertionError(f"[18b] {label}: the int64 index does not give the int32 index's candidates and PSMs")
        if min(n[p + tag] for p in kernel_passes) <= 0:
            raise AssertionError(f"[18b] {label}: a pass that runs the kernel launched it no time: {n}")
        launches.update({k + "_index64": v for k, v in n.items()})
        wide.free_device()
    torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--cli-process"]:  # one process of phase [15c] / [15d]
        return cli_process(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true", help="also trace one pass of each path")
    opt = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "alphadia_torch" / "csrc" / "xic.cu").exists():
        print(f"chip_smoke: the alphadia_torch package is not beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from alphadia_torch.ops import xic_cuda

    # ---- 1. the card ------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"[1] device: {name} x{count}; nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = xic_cuda.build(verbose=True)
    log(f"[2] built {lib.relative_to(root)} in {time.perf_counter() - t0:.2f} s ({card})")
    from alphadia_torch.rawdata import peakstore

    t0 = time.perf_counter()
    lib = peakstore.build()
    log(f"[2] built the peak-store builder {lib.relative_to(root)} with the host's C++ compiler in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- worlds (set-up) ----------------------------------------------------
    from alphadia_torch.rawdata import DiaData

    worlds, spectra = {}, {}
    for tag, n_pep, kw in (("", N_PEPTIDES, {}), ("_4d", N_PEPTIDES_4D, {"with_mobility": True})):
        t0 = time.perf_counter()
        spectra[tag], prec, frag = make_spectra(n_pep, N_CYCLES, **kw)
        dia = DiaData.from_spectra(spectra[tag], n_scan_bins=N_SCAN_BINS)
        worlds[tag] = dia, prec, frag
        dev = dia.device_arrays(1, DEVICE)
        store = dev["peak_store"] if "peak_store" in dev else (dev["peak_packed"],)
        store_bytes = sum(t.numel() * t.element_size() for t in store)
        log(
            f"[world{tag}] {len(prec['precursor_idx'])} precursors, {len(frag['mz_library'])} fragments, "
            f"{dia.n_stored_peaks} stored peaks, {dia.n_cycles} cycles x {dia.n_slots} slots, "
            f"{dia.n_scan_bins if dia.has_mobility else 1} scan bins, peak store on the card "
            f"{store_bytes / 2**20:.1f} MiB ({store_bytes / store[0].shape[0]:.0f} B a row), "
            f"built in {time.perf_counter() - t0:.2f} s"
        )

    # ---- 3. kernel vs plain on the card -----------------------------------
    calls, worst = record_and_compare(worlds, spectra)
    for v in ("a_intensity", "b_mz_delta", "c_scan_window", "d_coarse"):
        if v not in worst:
            raise AssertionError(f"variant {v} was not checked")
        log(f"[3] variant {v}: max_abs_err={worst[v][0]:.3g} max_rel_err={worst[v][1]:.3g} ({card})")
    max_abs_err = max(w[0] for w in worst.values())
    check_agreement("3D", with_mobility=False)
    check_agreement("4D", with_mobility=True)

    # ---- 4. the main paths --------------------------------------------------
    secs, launches, main_out = {}, {}, {}
    for label, tag, kernel_passes in (("3D", "", ("selection", "scoring", "selection_wide")), ("4D", "_4d", ("scoring",))):
        torch.cuda.reset_peak_memory_stats()
        out, s_, l_ = main_path(worlds[tag], tag)
        peak_mem = torch.cuda.max_memory_allocated()
        secs.update(s_)
        launches.update(l_)
        n_prec = len(worlds[tag][1]["precursor_idx"])
        log(
            f"[4] {label}: wall s: " + ", ".join(f"{k} {v:.4f}" for k, v in s_.items())
            + f"; {n_prec / (s_['selection' + tag] + s_['scoring' + tag]):.1f} precursors/s (selection+scoring); "
            f"max_memory_allocated {peak_mem / 2**30:.3f} GiB ({name}, {card})"
        )
        path_checks(label, tag, worlds[tag], out, l_, kernel_passes)
        main_out[tag] = out  # phase [18b]'s reference
    timed_passes("3D", worlds[""], "", REPEATS, name, card)
    timed_passes("4D", worlds["_4d"], "_4d", REPEATS_4D, name, card)
    if opt.profile:
        for tag, world in worlds.items():
            profile_main_path(world, tag, root / "chiprun_out")

    # ---- 5. the kernel alone ----------------------------------------------
    from alphadia_torch.ops.xic import extract_xic_packed

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    zero = dict(ms=0.0, flushed_ms=0.0, plain_ms=0.0, bytes=0, covered=0, ops=0, plain_mem=0)
    tot = dict(zero)
    per_stage = {}
    plain_ms_of = []  # each launch's plain-version ms, for phase [15a]
    for stage, args, kw in calls:
        def kernel():
            return xic_cuda.extract_xic_cuda(*args, **kw)

        k_ms = device_ms(kernel, KERNEL_REPS)
        f_ms = device_ms_flushed(kernel, KERNEL_REPS, flush)
        p_ms = device_ms(lambda: extract_xic_packed(*args, **kw), PLAIN_REPS, warmup=1)
        plain_ms_of.append(p_ms)
        p_mem = plain_peak_bytes(args, kw)
        nbytes, ops = work(args, kw)
        # what the kernel of this checkout covers (older commits' kernels
        # read their f32[N, 4] store otherwise)
        cov = covered_bytes(args, kw) if isinstance(args[0], tuple) else 0
        bound = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        B, Q = args[2].shape
        log(
            f"[5] {stage:17s} {variant(kw):13s} B={B} Q={Q} W={kw['window_len']} kernel {k_ms:.4f} ms (L2 flushed "
            f"{f_ms:.4f}), plain {p_ms:.4f} ms (peak {p_mem / 2**20:.1f} MiB), bound {bound:.4f} ms "
            f"({nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mop), {nbytes / k_ms / 1e6:.1f} GB/s; the kernel's loads, "
            f"copies and stores cover {cov / 1e6:.2f} MB"
        )
        for acc in (tot, per_stage.setdefault(stage, dict(zero))):
            acc["ms"] += k_ms
            acc["flushed_ms"] += f_ms
            acc["plain_ms"] += p_ms
            acc["bytes"] += nbytes
            acc["covered"] += cov
            acc["ops"] += ops
            acc["plain_mem"] = max(acc["plain_mem"], p_mem)
    del flush
    for stage, acc in per_stage.items():
        b_ms = acc["bytes"] / HBM_BYTES_PER_S * 1e3
        n_launch = sum(1 for st, _, _ in calls if st == stage)
        wall = f"{secs[stage] * 1e3:.2f} ms" if stage in secs else "timed in phase [6]"
        log(
            f"[5] per pass {stage}: {n_launch} launches, kernel {acc['ms']:.4f} ms ({b_ms / acc['ms']:.2f} of "
            f"bound), L2 flushed {acc['flushed_ms']:.4f} ms ({b_ms / acc['flushed_ms']:.2f}), plain "
            f"{acc['plain_ms']:.4f} ms (peak {acc['plain_mem'] / 2**20:.1f} MiB), bound {b_ms:.4f} ms (bytes: "
            f"{acc['bytes'] / 1e6:.2f} MB of the function, {acc['covered'] / 1e6:.2f} MB covered by the kernel), wall of the "
            f"pass {wall} ({name}, {card})"
        )
    bound_ms = max(tot["bytes"] / HBM_BYTES_PER_S, tot["ops"] / FP32_OPS_PER_S) * 1e3
    bound_by = "bytes" if tot["bytes"] / HBM_BYTES_PER_S >= tot["ops"] / FP32_OPS_PER_S else "operations"
    scan_cells = phase5b(name, card)

    # ---- 6. IDs at 1% FDR ---------------------------------------------------
    classifier_card_vs_cpu(name, card)  # also the process's first fit on the card
    phase6("3D", "", worlds[""], name, card, launches, secs)
    phase6("4D", "_4d", worlds["_4d"], name, card, launches, secs, spectra=spectra["_4d"])
    log(f"[6] kernel launches per run: {json.dumps(launches)} ({name}, {card})")

    # ---- 7. the per-run workflow --------------------------------------------
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        workflow_card_vs_cpu(root, tmp, name, card)
        for label, tag in (("3D", ""), ("4D", "_4d")):
            _, prec, frag = worlds[tag]
            w = phase7(label, tag, spectra[tag], prec, frag, name, card, launches, secs, tmp)
            max_abs_err = max(max_abs_err, w[0])
        log(f"[7] kernel launches per run: {json.dumps(launches)} ({name}, {card})")

        # ---- 8. the search step ---------------------------------------------
        # worlds with m/z and isotope envelopes from the sequences, so that
        # the library's sequence-derived decoys compete. 3D at full width;
        # 4D at the quarter world of its JAX readings (see SS_BATCH_4D): the
        # full 4D world is written and read back from mzML only
        t0 = time.perf_counter()
        spec8, _, _ = make_spectra(N_PEPTIDES_4D, N_CYCLES, from_sequence=True, with_mobility=True)
        log(f"[8] 4D full world from sequences: {len(spec8.mz)} peaks, made in {time.perf_counter() - t0:.2f} s")
        mzml_round_trip("4D full world", spec8, tmp / "run_4d_full.mzML")
        spectra["_4d_full"] = spec8  # phase [11b]'s input
        for label, tag, n_pep, n_win, batch, kw in (
            ("3D", "", N_PEPTIDES, 12, None, {}),
            ("4D", "_4d", N_PEPTIDES_4D // 4, 3, SS_BATCH_4D, {"with_mobility": True}),
        ):
            t0 = time.perf_counter()
            spec8, prec, frag = make_spectra(n_pep, N_CYCLES, n_windows=n_win, from_sequence=True, **kw)
            log(
                f"[8] {label} world from sequences: {n_pep} peptides, {n_win} windows, {len(spec8.mz)} peaks, "
                f"made in {time.perf_counter() - t0:.2f} s"
            )
            w = phase8(root, label, tag, spec8, prec, frag, name, card, launches, secs, tmp, batch_size=batch)
            max_abs_err = max(max_abs_err, w[0])
            if tag == "_4d":
                spectra["_4d_quarter"] = spec8  # phase [17a]'s third world
            del spec8, prec, frag
        log(f"[8] kernel launches per run: {json.dumps(launches)} ({name}, {card})")

        # ---- 9. the CLI across two runs ---------------------------------------
        w, cli_inputs = phase9(root, name, card, launches, secs, tmp)
        max_abs_err = max(max_abs_err, w[0])
        log(f"[9] kernel launches per run: {json.dumps(launches)} ({name}, {card})")

        # ---- 10. library-free search ------------------------------------------
        w = phase10a(root, name, card, launches, secs, tmp)
        max_abs_err = max(max_abs_err, w[0])
        log(f"[10a] kernel launches per run: {json.dumps(launches)} ({name}, {card})")
        phase10b(name, card, tmp)

        # ---- 11. Bruker .d input ----------------------------------------------
        phase11a(root, name, card)
        phase11b(root, name, card, tmp, spectra.pop("_4d_full"))
        w = phase11c(root, name, card, launches, secs, tmp)
        max_abs_err = max(max_abs_err, w[0])
        log(f"[11c] kernel launches per run: {json.dumps(launches)} ({name}, {card})")

        # ---- 12. HDF ----------------------------------------------------------
        phase12a(root, name, card, tmp)
        phase12b(root, name, card, tmp)
        w = phase12c(root, name, card, launches, secs, tmp)
        max_abs_err = max(max_abs_err, w[0])
        log(f"[12c] kernel launches per run: {json.dumps(launches)} ({name}, {card})")

        # ---- 13. requantification ---------------------------------------------
        t13 = time.perf_counter()
        w = phase13a(root, name, card, launches, secs, tmp)
        max_abs_err = max(max_abs_err, w[0])
        w = phase13b(root, name, card, launches, secs, tmp)
        max_abs_err = max(max_abs_err, w[0])
        log(f"[13] kernel launches per run: {json.dumps(launches)}; phase [13] took {time.perf_counter() - t13:.2f} s; "
            f"launches held against the plain version in phases [7]-[13] beyond the requants: {PLAIN_SAMPLES['held']} "
            f"of {PLAIN_SAMPLES['launches']} ({name}, {card})")

        # ---- 14. the three-step plan -------------------------------------------
        t14 = time.perf_counter()
        w = phase14(root, name, card, launches, secs, tmp)
        max_abs_err = max(max_abs_err, w[0])
        log(f"[14] kernel launches per run: {json.dumps(launches)}; phase [14] took {time.perf_counter() - t14:.2f} s; "
            f"launches held against the plain version in phases [7]-[14] beyond the requants: {PLAIN_SAMPLES['held']} "
            f"of {PLAIN_SAMPLES['launches']} ({name}, {card})")

        # ---- 15. several processes and several shards on the one card ---------
        t15 = time.perf_counter()
        phase15a(calls, plain_ms_of, name, card)
        route = phase15b(worlds, name, card)
        phase15c(root, cli_inputs, name, card, secs, tmp)
        phase15d(root, cli_inputs, name, card, tmp)
        log(f"[15] phase [15] took {time.perf_counter() - t15:.2f} s; kernel launches per run of the main paths "
            f"({sum(launches.values())} in all): {json.dumps(launches)}; through the sharded route "
            f"in [15b] {route['launches']} (the xic_sharded entry's) ({name}, {card})")

        # ---- 16. figures and the GUI --------------------------------------------
        t16 = time.perf_counter()
        w = phase16a(worlds, name, card, launches, tmp)
        max_abs_err = max(max_abs_err, w[0])
        phase16b(name, card)
        phase16c(root, cli_inputs, name, card, tmp)
        log(f"[16] phase [16] took {time.perf_counter() - t16:.2f} s; kernel launches per run "
            f"({sum(launches.values())} in all, the xic entry's): {json.dumps(launches)} ({name}, {card})")

        # ---- 17. the peak-store builder and the two trainers ---------------------
        t17 = time.perf_counter()
        phase17a(spectra, name, card)
        w = phase17b(name, card, launches, tmp)
        max_abs_err = max(max_abs_err, w[0])
        phase17c(name, card)
        log(f"[17] phase [17] took {time.perf_counter() - t17:.2f} s; kernel launches per run "
            f"({sum(launches.values())} in all, the xic entry's): {json.dumps(launches)} ({name}, {card})")

    # ---- 18. a store past 2**31 entries: the int64 cell index -----------------
    t18 = time.perf_counter()
    wide = phase18a(calls, per_stage, name, card)
    launches64 = phase18b(worlds, main_out, name, card)
    log(f"[18] phase [18] took {time.perf_counter() - t18:.2f} s; kernel launches of the int64 instantiation on the "
        f"main paths ({sum(launches64.values())} in all, the xic_index64 entry's): {json.dumps(launches64)} ({name}, {card})")

    # ---- 19. summary lines --------------------------------------------------
    log(f"[19] scan-resolved kernel launches on the main paths: {SCAN_CELLS_MAIN['launches']} (the scan_cells "
        f"entry's), {SCAN_CELLS_MAIN['held']} held to the plain version, max abs err "
        f"{SCAN_CELLS_MAIN['max_abs_err']:.3g} ({name}, {card})")
    kernels = {
        "kernels": [
            {
                "name": "xic",
                "route": "cuda",
                "source": "alphadia_torch/csrc/xic.cu",
                "replaces": replaced_kernel(root),
                "launches": sum(launches.values()),
                "max_abs_err": max_abs_err,
                "ms": tot["ms"],
                "plain_ms": tot["plain_ms"],
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            },
            {
                "name": "xic_sharded",
                "route": "cuda",
                "source": "alphadia_torch/csrc/xic.cu",
                "route_source": "alphadia_torch/parallel/shard_ops.py",
                "replaces": replaced_sharded(root),
                "launches": route["launches"],
                "max_abs_err": route["max_abs_err"],
                "ms": route["ms"],
                "plain_ms": route["plain_ms"],
                "bound_ms": route["bound_ms"],
                "bound_by": route["bound_by"],
                "library_ms": None,
            },
            {
                "name": "scan_cells",
                "route": "cuda",
                "source": "alphadia_torch/csrc/scan_cells.cu",
                "replaces": None,
                "launches": SCAN_CELLS_MAIN["launches"],
                "max_abs_err": max(scan_cells["max_abs_err"], SCAN_CELLS_MAIN["max_abs_err"]),
                "ms": scan_cells["ms"],
                "plain_ms": scan_cells["plain_ms"],
                "bound_ms": scan_cells["bound_ms"],
                "bound_by": "bytes",
                "library_ms": None,
            },
            {
                "name": "xic_index64",
                "route": "cuda",
                "source": "alphadia_torch/csrc/xic.cu",
                "replaces": replaced_kernel(root),
                "launches": sum(launches64.values()),
                "max_abs_err": wide["max_abs_err"],
                "ms": wide["ms"],
                "plain_ms": wide["plain_ms"],
                "bound_ms": wide["bound_ms"],
                "bound_by": wide["bound_by"],
                "library_ms": None,
            },
        ]
    }
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
