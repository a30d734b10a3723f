"""One search step: the config layers, the library, the per-raw-file loop.

    SearchStep(output_folder, config={"library_path": "lib.tsv", "raw_paths": ["run.mzML"]}).run()

- the config: the packaged defaults < ``config`` < ``cli_config`` <
  ``extra_config`` (multistep extras), frozen to ``frozen_config.yaml``;
- the library: a TSV/CSV transition list or an HDF library, or with
  ``library_prediction.enabled`` and no library a FASTA digest
  (``fasta_paths``), through the harmonize steps and ``SimplePrediction``
  (the property models on the step's device), decoys and flattening
  (``load_library``); ``general.save_library`` writes ``speclib.hdf`` after
  the decoys, ``general.save_flat_library`` ``speclib.flat.hdf`` after
  flattening; with ``library_multiplexing.enabled`` the library is copied
  to every channel of ``multiplex_mapping`` before the decoys
  (``MultiplexLibrary``). A flat HDF library (the MBR step's) only gets its
  decoys;
- each raw file (``.mzML``, ``.mzML.gz``, ``.hdf``, ``.d``, ``.npz``): ``PeptideCentricWorkflow``
  ``load`` -> ``search_parameter_optimization`` -> ``extraction`` on the
  card (``device=None``) or where ``device`` says, then
  ``quant/<run>/psm.parquet`` and ``frag.parquet``; with
  ``transfer_library.enabled`` the PSMs quantified again over their whole
  fragment space (``requantify_fragments``) as ``frag.transfer.parquet``
  (the scored set where that finds fewer fragments); with
  ``general.profile_directory`` a ``torch.profiler`` trace of the three
  workflow stages in ``<profile_directory>/<run>/trace.json``
  (``utils/profiling``); ``reuse_quant`` skips a run whose ``psm.parquet``
  exists, errors are collected per run unless ``general.fail_fast``.

``run()`` ends with the cross-run outputs of every raw path's quant
folder (``SearchPlanOutput.build``: ``precursors``, the protein groups and
their FDR, ``stat.tsv``, ``internal.tsv``, the LFQ matrices, and with
``transfer_learning.enabled`` the property models fine-tuned on the
transfer library, on the step's device), on the host; under
``general.fail_fast`` a failed raw file's error is raised before it.

Several processes (``parallel/distributed``: ``torchrun``'s environment or
the JAX package's ``ALPHADIA_TPU_*``) each join one group before any work,
search their slice of the raw files (file i on process i % n) on their own
cards, and meet at a barrier; process 0 then builds the cross-run outputs
over every run's folder of the shared quant directory while the others wait
at a second barrier, so that every process leaves ``run()`` with the step's
outputs on disk. Under ``general.fail_fast`` a process's error is raised
after both barriers, so that no peer waits for it. File i draws the i-th
seed of the step's generator over the whole list of raw paths, on whichever
process searches it (the JAX package draws once for each file that a
process searches, so a file's seed there depends on the process and on the
files reused before it). The batches of a run are split across the
process's cards (``devices``, at most ``tpu.mesh_devices``); everything else
runs on its first card, ``device``. The
multiplexing requant (``PeptideCentricWorkflow.requantify``) has no caller
here, as in the JAX package: a multiplexed search is the channel library
searched by the normal path.
"""

from __future__ import annotations

import logging
import traceback
from pathlib import Path

import numpy as np
import torch

from alphadia_torch.config import load_default_config
from alphadia_torch.constants.keys import SearchStepFiles
from alphadia_torch.exceptions import CustomError, NoLibraryAvailableError
from alphadia_torch.library import chem
from alphadia_torch.library.decoy import DecoyGenerator, generate_flat_decoys
from alphadia_torch.library.digest import digest_fasta
from alphadia_torch.library.flatten import FlattenLibrary, InitFlatColumns, LogFlatLibraryStats
from alphadia_torch.library.harmonize import AnnotateFasta, IsotopeGenerator, PrecursorInitializer, RTNormalization
from alphadia_torch.library.loader import DynamicLoader
from alphadia_torch.library.multiplex import MultiplexLibrary
from alphadia_torch.library.pipeline import ProcessingPipeline
from alphadia_torch.library.speclib import SpecLibFlat
from alphadia_torch.models.prediction import SimplePrediction
from alphadia_torch.outputs.search_plan_output import SearchPlanOutput
from alphadia_torch.parallel.distributed import (
    barrier,
    initialize_distributed,
    local_devices,
    process_index,
    shard_files_for_host,
)
from alphadia_torch.reporting import PROGRESS, init_logging
from alphadia_torch.utils.device import resolve_device
from alphadia_torch.utils.frame import n_rows
from alphadia_torch.utils.parquet import write_parquet
from alphadia_torch.utils.profiling import profile_trace
from alphadia_torch.workflow.base import QUANT_FOLDER_NAME
from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow

logger = logging.getLogger(__name__)


class SearchStep:
    def __init__(
        self,
        output_folder: str,
        config: dict | None = None,
        cli_config: dict | None = None,
        extra_config: dict | None = None,
        device=None,
    ):
        # this process's cards unless a device is asked for; raises without
        # a card. The drivers split their batches across ``devices``; the
        # rest of the step runs on the first of them
        self.devices = local_devices() if device is None else [resolve_device(device)]
        self.device = self.devices[0]
        if self.device.index is not None and self.device.type == "cuda":
            # the first card is the process's current device: what launches
            # on the current device (the classifier's CUDA graph, streams)
            # then runs where the step's tensors lie ("cuda" alone is the
            # current device already)
            torch.cuda.set_device(self.device)
        self.output_folder = Path(output_folder)
        self.output_folder.mkdir(parents=True, exist_ok=True)

        self.config = load_default_config()
        self.config.update_layers([("user", config or {}), ("cli", cli_config or {}), ("multistep", extra_config or {})])
        init_logging(self.output_folder, log_level=self.config["general"]["log_level"])
        if not self.config["output_directory"]:
            self.config["output_directory"] = str(self.output_folder)
        self.config.to_yaml(self.output_folder / "frozen_config.yaml")

        # user-defined modifications (multiplex decoy channels and the like)
        for mod in self.config["custom_modifications"] or []:
            try:
                chem.register_custom_modification(mod["name"], mod["composition"])
            except Exception as e:
                logger.warning("custom modification %s: %s", mod.get("name"), e)

        # the per-file seeds: one generator for the step, drawn once a raw file
        seed = self.config["general"]["random_state"]
        if seed == -1:
            seed = int(np.random.default_rng().integers(0, 2**31))
            logger.info("Generated random state %d", seed)
        self._np_rng = np.random.default_rng(seed)
        self._file_seeds: dict[str, int | None] = {}  # raw path -> its seed, drawn in run()

        self.spectral_library: SpecLibFlat | None = None
        self.errors: list[tuple[str, str]] = []

    def load_library(self) -> SpecLibFlat:
        """The flat library: a transition list, or a FASTA digest when
        ``library_prediction.enabled`` and no library is given; harmonized,
        predicted where asked or where the library lacks RT or fragment
        intensities (the property models on the step's device), with decoys,
        flattened."""
        lib_path = self.config["library_path"]
        fasta_paths = list(self.config["fasta_paths"] or [])
        predict = self.config["library_prediction"]["enabled"]
        threads = self.config["general"]["thread_count"]
        if lib_path:
            lib = DynamicLoader()(lib_path)
        elif fasta_paths and predict:
            lp = self.config["library_prediction"]
            lib = digest_fasta(
                fasta_paths,
                enzyme=lp["enzyme"],
                missed_cleavages=lp["missed_cleavages"],
                fixed_modifications=lp["fixed_modifications"],
                variable_modifications=lp["variable_modifications"],
                max_var_mod_num=lp["max_var_mod_num"],
                precursor_len=tuple(lp["precursor_len"]),
                precursor_charge=tuple(lp["precursor_charge"]),
                precursor_mz=tuple(lp["precursor_mz"]),
            )
        else:
            raise NoLibraryAvailableError()

        if isinstance(lib, SpecLibFlat):
            # a flat input (the MBR library, saved without decoys unless
            # fdr.keep_decoys_in_mbr_library): its decoys made anew
            logger.info("Flat library loaded as-is")
            return generate_flat_decoys(lib)

        steps = [PrecursorInitializer(self.config["library_loading"]["drop_decoys"])]
        if fasta_paths and lib_path:
            steps.append(AnnotateFasta(fasta_paths))
        if predict or lib.fragment_intensity is None or "rt" not in lib.precursor_df:
            lp = self.config["library_prediction"]
            steps.append(
                SimplePrediction(
                    fragment_types=tuple(lp["fragment_types"]),
                    max_fragment_charge=lp["max_fragment_charge"],
                    model_path=lp["peptdeep_model_path"],
                    predict_charge=lp["predict_charge"],
                    min_charge_probability=lp["min_charge_probability"],
                    nce=lp["nce"],
                    instrument=lp["instrument"],
                    model_type=lp["peptdeep_model_type"],
                    device=self.device,
                )
            )
        lib = ProcessingPipeline(steps + [IsotopeGenerator(), RTNormalization()])(lib)
        if self.config["library_multiplexing"]["enabled"]:
            lm = self.config["library_multiplexing"]
            lib = MultiplexLibrary(lm["multiplex_mapping"], lm["input_channel"])(lib)

        lib = DecoyGenerator("diann")(lib)
        if self.config["general"]["save_library"]:
            lib.save_hdf(self.output_folder / "speclib.hdf", thread_count=threads)
        flat = ProcessingPipeline(
            [
                FlattenLibrary(self.config["search"]["top_k_fragments_scoring"], self.config["search"]["min_fragment_intensity"]),
                InitFlatColumns(),
                LogFlatLibraryStats(),
            ]
        )(lib)
        if self.config["general"]["save_flat_library"]:
            flat.save_hdf(self.output_folder / "speclib.flat.hdf", thread_count=threads)
        return flat

    def run(self) -> None:
        # join the group (if several processes run this step) before any
        # work: a peer that cannot join must stop every process
        is_distributed = initialize_distributed()
        self.spectral_library = self.load_library()

        quant_dir = Path(self.config["quant_directory"] or self.output_folder / QUANT_FOLDER_NAME)
        all_files = list(self.config["raw_paths"] or [])
        # file i's seed is the i-th draw, whichever process searches it
        seeded = self.config["general"]["random_state"] is not None
        self._file_seeds = {}
        for raw_path in all_files:
            self._file_seeds.setdefault(raw_path, int(self._np_rng.integers(0, 2**31)) if seeded else None)
        my_files = shard_files_for_host(all_files) if is_distributed else all_files
        if is_distributed:
            logger.log(PROGRESS, "distributed: this process searches %d/%d files", len(my_files), len(all_files))

        fail_fast_error: Exception | None = None
        for raw_path in my_files:
            raw_name = Path(raw_path).stem
            psm_path = quant_dir / raw_name / SearchStepFiles.PSM_FILE_NAME
            if self.config["general"]["reuse_quant"] and psm_path.exists():
                logger.log(PROGRESS, "Reusing quant for %s", raw_name)
                continue
            try:
                self._process_raw_file(raw_path, raw_name, quant_dir)
            except Exception as e:
                if isinstance(e, CustomError):
                    self.errors.append((raw_name, e.error_code))
                    logger.error("%s: %s: %s", raw_name, e.error_code, e)
                else:
                    self.errors.append((raw_name, str(e)))
                    logger.error("%s failed: %s\n%s", raw_name, e, traceback.format_exc())
                if self.config["general"]["fail_fast"]:
                    logger.error("fail_fast: skipping remaining raw files")
                    fail_fast_error = e
                    break
        if fail_fast_error is not None and not is_distributed:
            raise fail_fast_error

        # the outputs cover every run (each process's quant folders on the
        # shared filesystem) and are built once, by process 0, after every
        # process has written its runs
        folder_list = [quant_dir / Path(p).stem for p in all_files]
        if is_distributed:
            barrier("alphadia_torch_quant_done")
            if process_index() != 0:
                logger.log(PROGRESS, "distributed: the cross-run outputs are built on process 0")
                barrier("alphadia_torch_output_done")
                if fail_fast_error is not None:
                    raise fail_fast_error
                return
        try:
            SearchPlanOutput(self.config, self.output_folder, self.device).build(folder_list, self.spectral_library)
        finally:
            if is_distributed:
                barrier("alphadia_torch_output_done")
        if fail_fast_error is not None:
            raise fail_fast_error

    def _process_raw_file(self, raw_path: str, raw_name: str, quant_dir: Path) -> None:
        workflow = PeptideCentricWorkflow(
            raw_name, self.config, quant_path=str(quant_dir), random_state=self._file_seeds[raw_path],
            devices=self.devices,
        )
        profile_dir = self.config["general"].get("profile_directory")
        with profile_trace(Path(profile_dir) / raw_name if profile_dir else None):
            workflow.load(raw_path, self.spectral_library.copy())
            workflow.search_parameter_optimization()
            psm_df, frag_df = workflow.extraction()
        frag_transfer_df = None
        if self.config["transfer_library"]["enabled"]:
            # an error here is the run's error, as one in extraction() is:
            # nothing of the run is written
            _, frag_transfer_df = workflow.requantify_fragments(psm_df)
            if n_rows(frag_transfer_df) < n_rows(frag_df):
                # the sequence-derived fragment space did not meet the data
                # (a library whose fragment m/z do not follow its sequences)
                logger.warning(
                    "transfer requantification matched fewer fragments (%d) than the scored set (%d); keeping the "
                    "scored set", n_rows(frag_transfer_df), n_rows(frag_df),
                )
                frag_transfer_df = frag_df
        write_parquet(psm_df, workflow.path / SearchStepFiles.PSM_FILE_NAME)
        write_parquet(frag_df, workflow.path / SearchStepFiles.FRAG_FILE_NAME)
        if frag_transfer_df is not None:
            write_parquet(frag_transfer_df, workflow.path / SearchStepFiles.FRAG_TRANSFER_FILE_NAME)
        workflow.dia_data.free_device()

