"""The per-run workflow with ``general.save_figures`` on, in both packages:
the port writes ``quant/<run>/figures/fdr.png`` where the JAX package
writes it, at the same pixel size, and logs no warning about figures; its
PSMs and fragments are bit for bit those of the same run with figures off,
which writes no ``figures`` folder.
"""

import logging

import numpy as np
import pytest
from PIL import Image

from alphadia_torch.config import load_default_config
from alphadia_torch.convert import frame_from_pandas
from alphadia_torch.library.speclib import SpecLibFlat
from alphadia_torch.utils.png import read_png
from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow
from alphadia_tpu.config import load_default_config as jax_load_default_config
from alphadia_tpu.library.speclib import SpecLibFlat as JaxSpecLibFlat
from alphadia_tpu.rawdata.source import save_npz
from alphadia_tpu.testing.synthetic import SyntheticConfig, add_synthetic_decoys, make_synthetic_dia
from alphadia_tpu.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow as JaxWorkflow
from torch_workflow_worlds import run_workflow

pytest_plugins = ("torch_port_plugin",)

WORLD = dict(n_peptides=150, n_windows=4, n_cycles=200, seed=11)
CONFIG = {
    "general": {"random_state": 3},
    "calibration": {"batch_size": 150, "optimization_lock_target": 50, "min_steps": 2, "max_steps": 4},
    "tpu": {"selection_batch": 256, "scoring_batch": 256},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("figures_wf")
    spectra, prec, frag = make_synthetic_dia(SyntheticConfig(**WORLD))
    prec, frag = add_synthetic_decoys(prec, frag)
    raw = tmp / "run.npz"
    save_npz(raw, spectra)
    jcfg = jax_load_default_config()
    jcfg.update_layer(CONFIG, name="test")
    assert jcfg["general"]["save_figures"] is True  # the default
    run_workflow(lambda c: JaxWorkflow("run", c), jcfg, str(raw), JaxSpecLibFlat(prec.copy(), frag.copy()), tmp / "jax")

    class Warnings(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    out = {}
    for save in (True, False):
        cfg = load_default_config()
        cfg.update_layer(CONFIG, name="test")
        cfg.update_layer({"general": {"save_figures": save}}, name="figures")
        kept = Warnings()
        logging.getLogger("alphadia_torch").addHandler(kept)
        try:
            wf, psm, fragments = run_workflow(
                lambda c: PeptideCentricWorkflow("run", c, device="cpu"), cfg, str(raw),
                SpecLibFlat(frame_from_pandas(prec), frame_from_pandas(frag)), tmp / f"port_{save}",
            )
        finally:
            logging.getLogger("alphadia_torch").removeHandler(kept)
        out[save] = (wf, psm, fragments, kept.messages)
    return tmp, out


def test_fdr_png_lands_where_jax_writes_it(runs):
    tmp, out = runs
    jax_png = tmp / "jax" / "quant" / "run" / "figures" / "fdr.png"
    port_png = tmp / "port_True" / "quant" / "run" / "figures" / "fdr.png"
    assert jax_png.exists() and port_png.exists()
    with Image.open(jax_png) as im:
        size = im.size
    img = read_png(port_png)
    assert (img.shape[1], img.shape[0]) == size == (1080, 420)
    # the outlines in the first two colours of the cycle: targets, and decoys
    # (the final fit keeps few of them here: the legend's swatch at least)
    for color, least in (((31, 119, 180), 200), ((255, 127, 14), 10)):
        assert (np.abs(img[..., :3].astype(int) - color).max(axis=2) <= 8).sum() > least
    assert not any("figure" in m for m in out[True][3]), out[True][3]


def test_figures_do_not_change_the_psms(runs):
    tmp, out = runs
    (_, psm_on, frag_on, _), (_, psm_off, frag_off, _) = out[True], out[False]
    assert not (tmp / "port_False" / "quant" / "run" / "figures").exists()
    for a, b in ((psm_on, psm_off), (frag_on, frag_off)):
        assert list(a) == list(b)
        for c in a:
            np.testing.assert_array_equal(a[c], b[c], err_msg=c)
    assert len(psm_on["precursor_idx"]) > 50
