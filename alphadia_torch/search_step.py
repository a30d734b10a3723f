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
Several hosts, whose code comes with a later slice, raise
``NotPortedError`` naming it, before any work. The
multiplexing requant (``PeptideCentricWorkflow.requantify``) has no caller
here, as in the JAX package: a multiplexed search is the channel library
searched by the normal path.
"""

from __future__ import annotations

import logging
import os
import traceback
from pathlib import Path

import numpy as np

from alphadia_torch.config import load_default_config
from alphadia_torch.constants.keys import SearchStepFiles
from alphadia_torch.exceptions import CustomError, NoLibraryAvailableError, NotPortedError
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
        # the card unless the CPU is asked for; raises without a card
        self.device = resolve_device(device)
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

        self.spectral_library: SpecLibFlat | None = None
        self.errors: list[tuple[str, str]] = []

    def _refuse_later_slices(self) -> None:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise NotPortedError(
                "searching on several hosts or cards comes with the multi-GPU slice of the port "
                "(ROADMAP queue 1 item 7)"
            )

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
        self._refuse_later_slices()
        self.spectral_library = self.load_library()

        quant_dir = Path(self.config["quant_directory"] or self.output_folder / QUANT_FOLDER_NAME)
        for raw_path in list(self.config["raw_paths"] or []):
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
                    raise

        folder_list = [quant_dir / Path(p).stem for p in list(self.config["raw_paths"] or [])]
        SearchPlanOutput(self.config, self.output_folder, self.device).build(folder_list, self.spectral_library)

    def _process_raw_file(self, raw_path: str, raw_name: str, quant_dir: Path) -> None:
        per_file_seed = int(self._np_rng.integers(0, 2**31)) if self.config["general"]["random_state"] is not None else None
        workflow = PeptideCentricWorkflow(
            raw_name, self.config, quant_path=str(quant_dir), random_state=per_file_seed, device=self.device
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

