"""What the per-run workflow sets up before it searches, the port against
the JAX package: the run's library (library RT on the run's gradient,
precursors outside the quadrupole range dropped, the channel filter, the
unfiltered frames kept), the run's event stream (``events.jsonl``), the
timing manager's table and the log files."""

import json
import logging

import numpy as np
import pytest

from alphadia_torch.convert import frame_from_pandas
from alphadia_torch.library.speclib import SpecLibFlat
from alphadia_torch.rawdata import DiaData
from alphadia_torch.reporting import reporting as port_reporting
from alphadia_torch.workflow.managers.timing_manager import TimingManager
from alphadia_torch.workflow.peptidecentric.library_init import init_spectral_library
from alphadia_tpu.library.speclib import SpecLibFlat as JaxSpecLibFlat
from alphadia_tpu.reporting import reporting as jax_reporting
from alphadia_tpu.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
from alphadia_tpu.workflow.managers.timing_manager import TimingManager as JaxTimingManager
from alphadia_tpu.workflow.peptidecentric.library_init import init_spectral_library as jax_init_spectral_library

pytest_plugins = ("torch_port_plugin",)


def _assert_frames_equal(ours: dict, theirs, what: str):
    assert list(ours) == list(theirs.columns), what
    for c in theirs.columns:
        np.testing.assert_array_equal(ours[c], theirs[c].to_numpy(), err_msg=f"{what}: {c}")
        assert ours[c].dtype == theirs[c].to_numpy().dtype, f"{what}: {c}"


@pytest.mark.parametrize("channel_filter", ["", "0", "4"])
def test_library_init_matches_jax(channel_filter):
    """Library RT in minutes (another scale than the run's seconds) and
    precursors beyond the isolation windows, so both the mapping and the
    filter act."""
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(n_peptides=300, n_windows=3, n_cycles=200, seed=4))
    prec, frag = add_synthetic_decoys(prec, frag)
    prec["rt_library"] = (prec["rt_library"] / 60.0).astype(np.float32)
    prec.loc[prec.index[::7], "mz_library"] = np.float32(1900.0)
    dia = DiaData.from_spectra(spectra)
    theirs = jax_init_spectral_library(dia.cycle, dia.cycle_rt, JaxSpecLibFlat(prec.copy(), frag.copy()), channel_filter)
    ours = init_spectral_library(
        dia.cycle, dia.cycle_rt, SpecLibFlat(frame_from_pandas(prec), frame_from_pandas(frag)), channel_filter
    )
    assert ours.n_precursors == len(theirs.precursor_df) < len(prec)
    _assert_frames_equal(ours.precursor_df, theirs.precursor_df, "precursors")
    _assert_frames_equal(ours.fragment_df, theirs.fragment_df, "fragments")
    _assert_frames_equal(ours.precursor_df_unfiltered, theirs.precursor_df_unfiltered, "unfiltered precursors")
    _assert_frames_equal(ours.fragment_df_unfiltered, theirs.fragment_df_unfiltered, "unfiltered fragments")


def _events(module, path):
    with module.default_pipeline(path) as pipe:
        pipe.log_event("load", "start")
        pipe.log_metric("extraction.precursors", 1234)
        pipe.log_string("a line", verbosity="progress")
    pipe.log_event("outside", None)  # after the context: opens the file again
    pipe.context_stop()
    return [json.loads(line) for line in (path / "events.jsonl").read_text().splitlines()]


def test_event_stream_matches_jax(tmp_path):
    ours = _events(port_reporting, tmp_path / "port")
    theirs = _events(jax_reporting, tmp_path / "jax")
    assert [(e["type"], e["name"], e["value"]) for e in ours] == [(e["type"], e["name"], e["value"]) for e in theirs]
    assert [sorted(e) for e in ours] == [sorted(e) for e in theirs]
    assert all(e["relative_time"] >= 0 and e["absolute_time"] > 1e9 for e in ours)


def test_timing_table_matches_jax():
    ours, theirs = TimingManager(), JaxTimingManager()
    timings = {"load": {"start": 10.0, "end": 12.5, "duration": 2.5}, "optimization": {"start": 12.5}}
    ours.timings = {k: dict(v) for k, v in timings.items()}
    theirs.timings = {k: dict(v) for k, v in timings.items()}
    table, ref = ours.to_df(), theirs.to_df()
    assert table["phase"].tolist() == ref["phase"].tolist()
    np.testing.assert_array_equal(table["duration"], ref["duration"].to_numpy())


def test_logging_keeps_the_previous_log(tmp_path):
    """``init_logging`` writes ``log.txt`` and keeps the previous one as
    ``log.bkp.txt``; the workflow's PROGRESS level (25) reaches the file."""
    logger = logging.getLogger("alphadia_torch.test_run_setup")
    try:
        for i in range(2):
            port_reporting.init_logging(tmp_path, log_level="PROGRESS")
            logger.log(port_reporting.PROGRESS, "run %d", i)
        assert "run 1" in (tmp_path / "log.txt").read_text()
        assert "run 0" in (tmp_path / "log.bkp.txt").read_text()
        assert logging.getLevelName(port_reporting.PROGRESS) == "PROGRESS" and port_reporting.PROGRESS == jax_reporting.PROGRESS
    finally:
        for h in list(port_reporting.logger.handlers):
            h.close()
            port_reporting.logger.removeHandler(h)
