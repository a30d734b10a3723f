"""String constants: column names, output file names, quant levels and the
output column mapping, as the JAX package names them."""

from __future__ import annotations


class ConstantsClass(type):
    """Metaclass for namespaces of immutable string constants."""

    def __setattr__(cls, name, value):
        raise TypeError("Constants class cannot be modified")

    def get_values(cls):
        return [v for k, v in cls.__dict__.items() if not k.startswith("__") and isinstance(v, str)]


class CalibCols(metaclass=ConstantsClass):
    MZ_OBSERVED = "mz_observed"
    MZ_LIBRARY = "mz_library"
    MZ_CALIBRATED = "mz_calibrated"
    RT_OBSERVED = "rt_observed"
    RT_LIBRARY = "rt_library"
    RT_CALIBRATED = "rt_calibrated"
    MOBILITY_OBSERVED = "mobility_observed"
    MOBILITY_LIBRARY = "mobility_library"
    MOBILITY_CALIBRATED = "mobility_calibrated"


class SearchStepFiles(metaclass=ConstantsClass):
    PSM_FILE_NAME = "psm.parquet"
    FRAG_FILE_NAME = "frag.parquet"
    FRAG_TRANSFER_FILE_NAME = "frag.transfer.parquet"


class InferenceStrategy(metaclass=ConstantsClass):
    LIBRARY = "library"
    MAXIMUM_PARSIMONY = "maximum_parsimony"
    HEURISTIC = "heuristic"


class QuantLevelName(metaclass=ConstantsClass):
    PRECURSOR = "precursor"
    PEPTIDE = "peptide"
    PROTEIN = "pg"


class QuantLevelKey(metaclass=ConstantsClass):
    PRECURSOR = "mod_seq_charge_hash"
    PEPTIDE = "mod_seq_hash"
    PROTEIN = "pg"


class NormalizationMethods(metaclass=ConstantsClass):
    DIRECTLFQ = "directlfq"
    QUANTSELECT = "quantselect"


class StatOutputCols(metaclass=ConstantsClass):
    OPTIMIZATION_PREFIX = "optimization."
    MS1_ERROR = "ms1_error"
    MS2_ERROR = "ms2_error"
    RT_ERROR = "rt_error"
    MOBILITY_ERROR = "mobility_error"


# internal (wide, snake_case) -> user-facing (dotted) output column names;
# only mapped columns are kept in the precursor output table
INTERNAL_TO_OUTPUT_MAPPING: dict[str, str] = {
    "peptide_lfq_intensity": "peptide.intensity",
    "precursor_lfq_intensity": "precursor.intensity",
    "precursor_idx": "precursor.idx",
    "elution_group_idx": "precursor.elution_group_idx",
    "rank": "precursor.rank",
    "naa": "precursor.naa",
    "sequence": "precursor.sequence",
    "charge": "precursor.charge",
    "mods": "precursor.mods",
    "mod_sites": "precursor.mod_sites",
    "mod_seq_hash": "precursor.mod_seq_hash",
    "mod_seq_charge_hash": "precursor.mod_seq_charge_hash",
    "mz_library": "precursor.mz.library",
    "mz_observed": "precursor.mz.observed",
    "mz_calibrated": "precursor.mz.calibrated",
    "rt_library": "precursor.rt.library",
    "rt_observed": "precursor.rt.observed",
    "rt_calibrated": "precursor.rt.calibrated",
    "mobility_library": "precursor.mobility.library",
    "mobility_observed": "precursor.mobility.observed",
    "mobility_calibrated": "precursor.mobility.calibrated",
    "qval": "precursor.qval",
    "proba": "precursor.proba",
    "score": "precursor.score",
    "cycle_fwhm": "precursor.rt.fwhm",
    "mobility_fwhm": "precursor.mobility.fwhm",
    "channel": "precursor.channel",
    "decoy": "precursor.decoy",
    "pg": "pg.name",
    "pg_lfq_intensity": "pg.intensity",
    "proteins": "pg.proteins",
    "genes": "pg.genes",
    "pg_master": "pg.master_protein",
    "pg_qval": "pg.qval",
    "run": "raw.name",
}
