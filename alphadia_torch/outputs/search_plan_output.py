"""Cross-run outputs of a search step, on the host.

``SearchPlanOutput(config, output_folder).build(folder_list, library)``
reads every run's ``psm.parquet`` / ``frag.parquet`` and the managers'
pickles and writes:

- ``precursors``: the runs' PSMs concatenated in folder order, protein
  groups (``library`` / ``heuristic`` / ``maximum_parsimony`` inference),
  the protein FDR and its ``pg_qval`` filter (too few proteins: ``pg_qval``
  NaN, no filter), decoys dropped unless ``fdr.keep_decoys``, then the LFQ
  intensities of each level; columns renamed by
  ``INTERNAL_TO_OUTPUT_MAPPING`` (only mapped ones kept);
- ``stat.tsv`` (counts, ``optimization.*`` tolerances, ``calibration.*``
  metrics per run) and ``internal.tsv`` (phase durations);
- ``precursor.matrix``, ``peptide.matrix``, ``pg.matrix`` (and
  ``fragment.matrix`` with ``save_fragment_quant_matrix``): directLFQ or
  QuantSelect intensities, groups x runs;
- with ``general.save_mbr_library``, the MBR library (``outputs/mbr``:
  the precursors identified at ``fdr.fdr``, their observed RT) as
  ``speclib.mbr.hdf``, the MBR step's input; a library that cannot be built
  or written is logged as a warning, as the JAX package logs any failure of
  that step;
- with ``transfer_library.enabled`` the transfer library
  (``speclib.transfer*.parquet``), and with ``transfer_learning.enabled``
  the property models fine-tuned on it on ``device``
  (``peptdeep.transfer/models.pkl``, the next step's
  ``library_prediction.peptdeep_model_path``) and their metrics
  (``stats.transfer.tsv``).

Tables are parquet (``search_output.file_format``) or TSV. ``timings``
holds the stages' walls (read, grouping, protein FDR with the MLP's fit
seconds and epochs, LFQ per level, each model's fit with its epochs and
steps, writes).
"""

from __future__ import annotations

import logging
import pickle
import time
from pathlib import Path

import numpy as np

from alphadia_torch.constants.keys import INTERNAL_TO_OUTPUT_MAPPING, QuantLevelKey, QuantLevelName, SearchStepFiles
from alphadia_torch.exceptions import NoPsmFoundError, TooFewProteinsError
from alphadia_torch.outputs.df_builders import (
    build_internal_row,
    build_stat_rows,
    collect_calibration_metrics,
    rows_to_frame,
)
from alphadia_torch.outputs.grouping import perform_grouping
from alphadia_torch.outputs.protein_fdr import perform_protein_fdr
from alphadia_torch.outputs.quant import (
    DEFAULT_FEATURES,
    QUANTSELECT_FEATURES,
    accumulate_frag_df,
    direct_lfq,
    filter_frag_df,
    quantselect_lfq,
)
from alphadia_torch.outputs.transfer_library import accumulate_transfer_library
from alphadia_torch.reporting import PROGRESS
from alphadia_torch.utils.frame import concat, n_rows, take
from alphadia_torch.utils.parquet import read_parquet, write_parquet
from alphadia_torch.utils.tsv import write_tsv

logger = logging.getLogger(__name__)

PSM_OUTPUT_NAME = "precursors"
STAT_OUTPUT_NAME = "stat"
INTERNAL_OUTPUT_NAME = "internal"
PG_OUTPUT_NAME = "pg.matrix"
LEVEL_KEYS = {
    QuantLevelName.PRECURSOR: QuantLevelKey.PRECURSOR,
    QuantLevelName.PEPTIDE: QuantLevelKey.PEPTIDE,
    QuantLevelName.PROTEIN: QuantLevelKey.PROTEIN,
}


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _reindex(psm_df: dict, key: str, precursor_idx: np.ndarray) -> np.ndarray:
    """pandas' ``psm.drop_duplicates("precursor_idx").set_index(
    "precursor_idx")[key].reindex(precursor_idx)``: a numeric column
    becomes float64 where a precursor is missing (NaN), a text column holds
    NaN there."""
    prec = np.asarray(psm_df["precursor_idx"]).tolist()
    values = np.asarray(psm_df[key])
    first: dict = {}
    for i, p in enumerate(prec):
        first.setdefault(p, i)
    rows = [first.get(p, -1) for p in np.asarray(precursor_idx).tolist()]
    rows = np.asarray(rows, np.int64)
    missing = rows < 0
    if values.dtype.kind == "O":
        out = values[np.where(missing, 0, rows)] if len(values) else np.full(len(rows), np.nan, object)
        out = np.array(out, dtype=object)
        out[missing] = np.nan
        return out
    if not missing.any():
        return values[rows]
    out = np.full(len(rows), np.nan)
    out[~missing] = values[rows[~missing]].astype(np.float64)
    return out


def _notna(values: np.ndarray) -> np.ndarray:
    if values.dtype.kind == "f":
        return ~np.isnan(values)
    if values.dtype.kind == "O":
        return np.array([not _is_missing(v) for v in values], bool)
    return np.ones(len(values), bool)


class SearchPlanOutput:
    def __init__(self, config, output_folder: str | Path, device=None):
        self.config = config
        self.output_folder = Path(output_folder)
        # where the transfer step fine-tunes its models: the card unless the
        # CPU is asked for
        self.device = device
        self.timings: dict = {}

    def build(self, folder_list: list[str | Path], base_spec_lib=None) -> dict:
        t0 = time.perf_counter()
        psm_df = self._build_precursor_table(folder_list)
        t1 = time.perf_counter()
        self._build_stat_df(folder_list, psm_df)
        self._build_internal_df(folder_list)
        t2 = time.perf_counter()
        psm_df = self._build_lfq_tables(folder_list, psm_df)
        t3 = time.perf_counter()
        if self.config["general"]["save_mbr_library"] and base_spec_lib is not None:
            self._build_mbr_library(psm_df, base_spec_lib)
        t4 = time.perf_counter()
        if self.config["transfer_library"]["enabled"]:
            transfer_psm, transfer_frag = self._build_transfer_library(folder_list)
            self.timings["transfer_library_s"] = time.perf_counter() - t4
            if self.config["transfer_learning"]["enabled"] and n_rows(transfer_psm):
                self._build_transfer_model(transfer_psm, transfer_frag)
        t5 = time.perf_counter()
        self._write(psm_df, PSM_OUTPUT_NAME)
        t6 = time.perf_counter()
        self.timings.update(precursor_table_s=t1 - t0, stat_internal_s=t2 - t1, lfq_s=t3 - t2, mbr_s=t4 - t3,
                            transfer_s=t5 - t4, write_precursors_s=t6 - t5, build_s=t6 - t0)
        return psm_df

    def _build_transfer_library(self, folder_list) -> tuple[dict, dict]:
        """``speclib.transfer.parquet`` and ``speclib.transfer.fragments.parquet``
        (none where no PSM passes the MS2 QC)."""
        tl = self.config["transfer_library"]
        psm, frag = accumulate_transfer_library(
            folder_list,
            top_k_samples=tl["top_k_samples"],
            precursor_correlation_cutoff=tl["precursor_correlation_cutoff"],
            fragment_correlation_ratio=tl["fragment_correlation_ratio"],
            norm_delta_max=tl["norm_delta_max"],
        )
        if n_rows(psm):
            write_parquet(psm, self.output_folder / "speclib.transfer.parquet")
            write_parquet(frag, self.output_folder / "speclib.transfer.fragments.parquet")
        return psm, frag

    def _build_transfer_model(self, transfer_psm: dict, transfer_frag: dict) -> None:
        """The property models fine-tuned on the transfer library
        (``peptdeep.transfer/models.pkl``) and their metrics, the list-valued
        ones left out (``stats.transfer.tsv``). The JAX package logs a failed
        charge or MS2 fit as a warning; here it is the step's error."""
        from alphadia_torch.models.finetune import MODEL_DIR_NAME, FinetuneManager

        manager = FinetuneManager(self.config["transfer_learning"], device=self.device)
        stats = {}
        fits = (
            ("rt", lambda: manager.finetune_rt(transfer_psm)),
            ("charge", lambda: manager.finetune_charge(transfer_psm)),
            ("ms2", lambda: manager.finetune_ms2(transfer_psm, transfer_frag)),
            ("ccs", lambda: manager.finetune_ccs(transfer_psm)),
        )
        for name, fit in fits:
            manager.trainer.last_fit = {}
            t0 = time.perf_counter()
            metrics = fit()
            self.timings[f"finetune_{name}_s"] = time.perf_counter() - t0
            self.timings[f"finetune_{name}_epochs"] = manager.trainer.last_fit.get("epochs", 0)
            self.timings[f"finetune_{name}_steps"] = manager.trainer.last_fit.get("steps", 0)
            if name != "ccs":  # the reference's stats row holds no mobility metrics
                stats.update({f"{name}_{k}": v for k, v in metrics.items() if not isinstance(v, list)})
        manager.save(self.output_folder / MODEL_DIR_NAME)
        write_tsv({k: np.asarray([v]) for k, v in stats.items()}, self.output_folder / "stats.transfer.tsv")

    def _build_mbr_library(self, psm_df: dict, base_spec_lib) -> None:
        from alphadia_torch.outputs.mbr import MbrLibraryBuilder

        try:
            mbr_lib = MbrLibraryBuilder(
                fdr=self.config["fdr"]["fdr"], keep_decoys=self.config["fdr"]["keep_decoys_in_mbr_library"]
            )(psm_df, base_spec_lib)
            mbr_lib.save_hdf(self.output_folder / "speclib.mbr.hdf", thread_count=self.config["general"]["thread_count"])
        except Exception as e:
            logger.warning(f"could not build MBR library: {e}")

    def _load_run_psm(self, folder: Path) -> dict | None:
        path = Path(folder) / SearchStepFiles.PSM_FILE_NAME
        if not path.exists():
            logger.warning(f"missing {path}")
            return None
        df = read_parquet(path)
        df["run"] = np.full(n_rows(df), Path(folder).name, dtype=object)
        return df

    def _build_precursor_table(self, folder_list) -> dict:
        t0 = time.perf_counter()
        frames = [self._load_run_psm(f) for f in folder_list]
        frames = [f for f in frames if f is not None and n_rows(f)]
        if not frames:
            raise NoPsmFoundError()
        psm_df = concat(frames)
        t1 = time.perf_counter()

        group_level = self.config["fdr"]["group_level"]
        strategy = self.config["fdr"]["inference_strategy"]
        if strategy == "library":
            psm_df["pg"] = np.asarray(psm_df[group_level], object)
            psm_df["pg_master"] = np.array(
                [v if _is_missing(v) else str(v).split(";")[0] for v in psm_df[group_level]], dtype=object
            )
        else:
            psm_df = perform_grouping(
                psm_df,
                genes_or_proteins=group_level,
                group=strategy == "heuristic",
                return_parsimony_groups=strategy == "maximum_parsimony",
            )
        t2 = time.perf_counter()

        try:
            psm_df = perform_protein_fdr(psm_df, self.timings)
            with np.errstate(invalid="ignore"):
                psm_df = take(psm_df, psm_df["pg_qval"] <= self.config["fdr"]["fdr"])
        except TooFewProteinsError:
            logger.warning("too few proteins for protein FDR; skipping pg_qval filter")
            psm_df["pg_qval"] = np.full(n_rows(psm_df), np.nan)

        if not self.config["fdr"]["keep_decoys"]:
            psm_df = take(psm_df, np.asarray(psm_df["decoy"]) == 0)
        self.timings.update(read_s=t1 - t0, grouping_s=t2 - t1, protein_fdr_s=time.perf_counter() - t2)
        return psm_df

    def _build_stat_df(self, folder_list, psm_df: dict) -> dict:
        rows = []
        runs = np.asarray(psm_df["run"])
        for folder in folder_list:
            run = Path(folder).name
            run_psm = take(psm_df, runs == run)
            opt_state = self._load_optimization_state(Path(folder))
            cal_metrics = self._load_calibration_metrics(Path(folder))
            rows += build_stat_rows(run, run_psm, opt_state, cal_metrics)
        stat_df = rows_to_frame(rows)
        write_tsv(stat_df, self.output_folder / f"{STAT_OUTPUT_NAME}.tsv")
        return stat_df

    @staticmethod
    def _load_pickle(path: Path):
        if not path.exists():
            return None
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except Exception:
            return None

    @classmethod
    def _load_optimization_state(cls, folder: Path) -> dict | None:
        om = cls._load_pickle(folder / "optimization_manager.pkl")
        if om is None:
            return None
        return {k: getattr(om, k) for k in ("ms1_error", "ms2_error", "rt_error", "mobility_error") if hasattr(om, k)}

    @classmethod
    def _load_calibration_metrics(cls, folder: Path) -> dict | None:
        cm = cls._load_pickle(folder / "calibration_manager.pkl")
        return None if cm is None else collect_calibration_metrics(cm)

    def _build_internal_df(self, folder_list) -> dict:
        rows = []
        for folder in folder_list:
            tm = self._load_pickle(Path(folder) / "timing_manager.pkl")
            timings = getattr(tm, "timings", {}) if tm is not None else {}
            rows.append(build_internal_row(Path(folder).name, timings))
        internal_df = rows_to_frame(rows)
        write_tsv(internal_df, self.output_folder / f"{INTERNAL_OUTPUT_NAME}.tsv")
        return internal_df

    def _build_lfq_tables(self, folder_list, psm_df: dict) -> dict:
        run_frames = {}
        for folder in folder_list:
            path = Path(folder) / SearchStepFiles.FRAG_FILE_NAME
            if path.exists():
                df = read_parquet(path)
                if n_rows(df):
                    run_frames[Path(folder).name] = df
        if not run_frames:
            logger.warning("no fragment data found; skipping LFQ")
            return psm_df

        so = self.config["search_output"]
        method = so.get("normalization_method", "directlfq")
        feature_dfs = accumulate_frag_df(run_frames, columns=QUANTSELECT_FEATURES if method == "quantselect" else DEFAULT_FEATURES)
        run_cols = list(run_frames)
        min_correlation, top_n = so["min_correlation"], so["min_k_fragments"]

        if so["save_fragment_quant_matrix"]:
            frag_intensity_df, _, _ = filter_frag_df(
                feature_dfs["intensity"], feature_dfs["correlation"], min_correlation=min_correlation, top_n=top_n
            )
            self._write_table(frag_intensity_df, "fragment.matrix")

        levels = []
        if so["precursor_level_lfq"]:
            levels.append(QuantLevelName.PRECURSOR)
        if so["peptide_level_lfq"]:
            levels.append(QuantLevelName.PEPTIDE)
        levels.append(QuantLevelName.PROTEIN)

        for level in levels:
            t0 = time.perf_counter()
            key = LEVEL_KEYS[level]
            if key not in psm_df:
                continue
            keys = _reindex(psm_df, key, feature_dfs["intensity"]["precursor_idx"])
            valid = _notna(keys)
            eff_min_nonnan = so["min_nonnan"] if len(run_cols) >= so["min_nonnan"] else 1
            if method == "quantselect":
                lfq = quantselect_lfq(
                    {k: take(v, valid) for k, v in feature_dfs.items()}, keys[valid], run_cols, min_nonnan=eff_min_nonnan
                )
            else:
                level_intensity_df, _, keep = filter_frag_df(
                    take(feature_dfs["intensity"], valid),
                    take(feature_dfs["correlation"], valid),
                    min_correlation=min_correlation,
                    top_n=top_n,
                    group_keys=keys[valid],
                )
                if n_rows(level_intensity_df) == 0:
                    logger.warning(f"no fragments survived filtering at the {level} level; skipping")
                    continue
                lfq = direct_lfq(
                    level_intensity_df,
                    keys[valid][keep],
                    run_cols,
                    normalize=so["normalize_directlfq"],
                    min_nonnan=eff_min_nonnan,
                    num_samples=so["num_samples_quadratic"],
                )
            self._write_table(lfq, PG_OUTPUT_NAME if level == QuantLevelName.PROTEIN else f"{level}.matrix")
            psm_df = self._merge_lfq(psm_df, lfq, key, run_cols, f"{level}_lfq_intensity")
            self.timings[f"lfq_{level}_s"] = time.perf_counter() - t0
            self.timings[f"lfq_{level}_groups"] = n_rows(lfq)
        return psm_df

    @staticmethod
    def _merge_lfq(psm_df: dict, lfq: dict, key: str, run_cols: list[str], column: str) -> dict:
        """pandas' left merge of the melted matrix on (key, run): each PSM
        row gets its group's intensity in its run (NaN where none). A float
        group column (numeric keys with a missing precursor became float64)
        matches the keys by their float value, as pandas does."""
        as_float = lfq["group"].dtype.kind == "f"
        value_of = {}
        for run in run_cols:
            for g, v in zip(lfq["group"].tolist(), lfq[run].tolist()):
                value_of[(g, run)] = v
        psm_keys = np.asarray(psm_df[key])
        psm_keys = (psm_keys.astype(np.float64) if as_float and psm_keys.dtype.kind in "iuf" else psm_keys).tolist()
        psm_df = dict(psm_df)
        psm_df[column] = np.array(
            [value_of.get((k, r), np.nan) for k, r in zip(psm_keys, np.asarray(psm_df["run"]).tolist())], np.float64
        )
        return psm_df

    def _write_table(self, frame: dict, name: str) -> None:
        if self.config["search_output"]["file_format"] == "parquet":
            write_parquet(frame, self.output_folder / f"{name}.parquet")
        else:
            write_tsv(frame, self.output_folder / f"{name}.tsv")

    def _write(self, psm_df: dict, name: str) -> None:
        out = {INTERNAL_TO_OUTPUT_MAPPING[k]: v for k, v in psm_df.items() if k in INTERNAL_TO_OUTPUT_MAPPING}
        out = {c: out[c] for c in INTERNAL_TO_OUTPUT_MAPPING.values() if c in out}
        self._write_table(out, name)
        fmt = self.config["search_output"]["file_format"]
        logger.log(PROGRESS, f"Wrote {n_rows(out)} precursors to {name}.{fmt}")
