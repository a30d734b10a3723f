"""The system under test, ``alphadia_torch``, as the loops drive it: its peak
store built from the benchmark's spectra, its default configuration with
the traffic's settings, and its extraction handler."""

from __future__ import annotations

from types import SimpleNamespace


def dia_data(world, n_scan_bins: int, coarse_bin_width: float):
    """The program's ``DiaData`` of the run, through its own load path."""
    from alphadia_torch.rawdata.diadata import DiaData
    from alphadia_torch.rawdata.source import SpectrumData

    spectra = SpectrumData(
        rt=world.rt, ms_level=world.ms_level, isolation_lower_mz=world.isolation_lower_mz,
        isolation_upper_mz=world.isolation_upper_mz, peak_start_idx=world.spec_start[:-1],
        peak_stop_idx=world.spec_start[1:], mz=world.mz, intensity=world.intensity, mobility=world.mobility,
    )
    return DiaData.from_spectra(spectra, coarse_bin_width=coarse_bin_width, n_scan_bins=n_scan_bins)


def config(tpu: dict) -> dict:
    """The program's default configuration with ``tpu`` settings (the
    traffic's, then the configuration's own)."""
    from alphadia_torch.config import load_default_config

    cfg = load_default_config()
    cfg["tpu"].update(tpu)
    return cfg


def optimization_state(cfg: dict, dia, om: dict):
    """An optimization manager at the run's gradient holding ``om``."""
    from alphadia_torch.workflow.managers.optimization_manager import OptimizationManager

    mgr = OptimizationManager(cfg, gradient_length=dia.rt_max - dia.rt_min)
    mgr.update(**om)
    return mgr


def om_values(mgr) -> dict:
    """The state the drivers read, as plain values (for the reference)."""
    keys = ("rt_error", "ms1_error", "ms2_error", "num_candidates", "fwhm_rt", "quad_sigma", "quad_delta_mu")
    return {k: getattr(mgr, k) for k in keys}


def extraction_handler(cfg: dict, mgr, dia, device):
    from alphadia_torch.workflow.managers.calibration_manager import CalibrationManager
    from alphadia_torch.workflow.peptidecentric.column_name_handler import ColumnNameHandler
    from alphadia_torch.workflow.peptidecentric.extraction_handler import ExtractionHandler

    cols = ColumnNameHandler(
        CalibrationManager(has_ms1=dia.has_ms1, has_mobility=dia.has_mobility),
        dia_data_has_ms1=dia.has_ms1, dia_data_has_mobility=dia.has_mobility,
    )
    return ExtractionHandler.create_handler(cfg, mgr, cols, device=device)


def library(precursor: dict, fragment: dict):
    return SimpleNamespace(precursor_df=precursor, fragment_df=fragment)


def rows_of(table: dict, rows: slice) -> tuple[dict, slice]:
    """Rows ``rows`` of a library table (views), and the rows of the fragment
    table that they point to; fragment pointers are rebased to those rows."""
    out = {k: v[rows] for k, v in table.items()}
    if "flat_frag_start_idx" not in out or not len(out["flat_frag_start_idx"]):
        return out, slice(0, 0)
    lo = int(out["flat_frag_start_idx"].min())
    hi = int(out["flat_frag_stop_idx"].max())
    for k in ("flat_frag_start_idx", "flat_frag_stop_idx"):
        out[k] = out[k] - out[k].dtype.type(lo)
    return out, slice(lo, hi)
