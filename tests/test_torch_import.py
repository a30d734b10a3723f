"""The port imports without JAX, the JAX package, pandas or the other
packages it does not depend on (pyarrow, scikit-learn, xxhash, matplotlib,
PIL, yaml, h5py, lxml, zstandard), reads a Bruker ``.d``, writes and reads
HDF, draws its figures as PNG and builds the GUI's schema without them, and
its entry points refuse to run on a missing card
unless the CPU is asked for. Its sources name the JAX package only inside
the HDF format identifiers that both packages write and read."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytest_plugins = ("torch_port_plugin",)

REPO = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = """
import importlib.abc, sys
BLOCKED = (
    "jax", "jaxlib", "flax", "optax", "alphadia_tpu", "pandas",
    "sklearn", "xxhash", "matplotlib", "PIL", "yaml", "h5py", "lxml", "zstandard", "pyarrow",
)
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
import alphadia_torch
import alphadia_torch.convert
import alphadia_torch.ops.features
import alphadia_torch.ops.peaks
import alphadia_torch.ops.scoring
import alphadia_torch.ops.selection
import alphadia_torch.ops.xic
import alphadia_torch.search.common
import alphadia_torch.search.scoring
import alphadia_torch.search.selection
import alphadia_torch.search.pipelined
import alphadia_torch.search.streaming
import alphadia_torch.testing.synthetic
import alphadia_torch.utils.frame
import alphadia_torch.utils.hashing
import alphadia_torch.utils.misc
import alphadia_torch.fdr.qvalues
import alphadia_torch.fdr.fragcomp
import alphadia_torch.fdr.fdr
import alphadia_torch.models.classifier
import alphadia_torch.workflow.managers.base
import alphadia_torch.workflow.managers.fdr_manager
import alphadia_torch.workflow.peptidecentric.peptidecentric
import alphadia_torch.exceptions
import alphadia_torch.constants.keys
import alphadia_torch.config
import alphadia_torch.reporting
import alphadia_torch.rawdata.source
import alphadia_torch.calibration
import alphadia_torch.library.speclib
import alphadia_torch.search.quadrupole
import alphadia_torch.workflow.base
import alphadia_torch.workflow.managers.calibration_manager
import alphadia_torch.workflow.managers.optimization_manager
import alphadia_torch.workflow.managers.raw_file_manager
import alphadia_torch.workflow.managers.timing_manager
import alphadia_torch.workflow.optimizers.automatic
import alphadia_torch.workflow.optimizers.optimization_lock
import alphadia_torch.workflow.optimizers.targeted
import alphadia_torch.workflow.peptidecentric.column_name_handler
import alphadia_torch.workflow.peptidecentric.extraction_handler
import alphadia_torch.workflow.peptidecentric.library_init
import alphadia_torch.workflow.peptidecentric.optimization_handler
import alphadia_torch.workflow.peptidecentric.recalibration_handler
import alphadia_torch.search_step
import alphadia_torch.rawdata.mzml
import alphadia_torch.rawdata.numpress
import alphadia_torch.library.chem
import alphadia_torch.library.decoy
import alphadia_torch.library.digest
import alphadia_torch.library.flatten
import alphadia_torch.library.harmonize
import alphadia_torch.library.loader
import alphadia_torch.library.pipeline
import alphadia_torch.utils.parquet
import alphadia_torch.config.yaml_subset
import alphadia_torch.testing.mzml_writer
import alphadia_torch.testing.tsv_library
import alphadia_torch.utils.jax_random
import alphadia_torch.utils.tsv
import alphadia_torch.validation
import alphadia_torch.validation.schemas
import alphadia_torch.outputs.df_builders
import alphadia_torch.outputs.grouping
import alphadia_torch.outputs.mlp
import alphadia_torch.outputs.protein_fdr
import alphadia_torch.outputs.quant
import alphadia_torch.outputs.mbr
import alphadia_torch.outputs.search_plan_output
import alphadia_torch.fdr.fdrx
import alphadia_torch.search_plan
import alphadia_torch.cli
import alphadia_torch.models.property_models
import alphadia_torch.models.finetune
import alphadia_torch.models.prediction
import alphadia_torch.testing.fasta
import alphadia_torch.rawdata.bruker_tdf
import alphadia_torch.rawdata.zstd
import alphadia_torch.testing.tdf_writer
import alphadia_torch.utils.hdf5
import alphadia_torch.rawdata.hdf
import alphadia_torch.testing.alpharaw_writer
import alphadia_torch.testing.physics
import alphadia_torch.library.multiplex
import alphadia_torch.outputs.transfer_library
import alphadia_torch.workflow.peptidecentric.multiplexing_handler
import alphadia_torch.workflow.peptidecentric.transfer_requant_handler
import alphadia_torch.utils.profiling
import alphadia_torch.parallel
import alphadia_torch.parallel.mesh
import alphadia_torch.parallel.distributed
import alphadia_torch.parallel.shard_ops
import alphadia_torch.utils.png
import alphadia_torch.reporting.figure
import alphadia_torch.search.plotting
import alphadia_torch.gui
import alphadia_torch.gui.schema
import alphadia_torch.gui.server
import alphadia_torch.utils.cxx
import alphadia_torch.rawdata.peakstore
import alphadia_torch.scripts.train_default_classifier
import alphadia_torch.scripts.train_property_models
cfg = alphadia_torch.config.load_default_config()
assert cfg["tpu"]["gather_slab"] == 256
import tempfile
from pathlib import Path
import numpy as np
with tempfile.TemporaryDirectory() as d:
    scans = [(np.array([3, 9]), np.array([5, 6])), (np.array([4]), np.array([7]))]
    alphadia_torch.testing.tdf_writer.write_tdf(Path(d) / "run.d", [{"time": 0.0, "msms_type": 0, "scans": scans}])
    assert len(alphadia_torch.rawdata.bruker_tdf.read_bruker_d(Path(d) / "run.d").mz) == 3
    from alphadia_torch.rawdata import load_raw_file
    from alphadia_torch.testing.synthetic import SyntheticConfig, make_synthetic_dia
    spectra, prec, _ = make_synthetic_dia(SyntheticConfig(n_peptides=20, n_windows=2, n_cycles=10, seed=1))
    alphadia_torch.testing.alpharaw_writer.save_alpharaw_hdf(Path(d) / "run.hdf", spectra, thread_count=2)
    assert np.array_equal(load_raw_file(Path(d) / "run.hdf").mz, spectra.mz)
    flat = alphadia_torch.library.speclib.SpecLibFlat({"sequence": np.array(["PEPTIDE"], dtype=object)}, {"mz": np.ones(3, np.float32)})
    flat.save_hdf(Path(d) / "lib.hdf")
    back = alphadia_torch.library.loader.DynamicLoader()(Path(d) / "lib.hdf")
    assert list(back.precursor_df["sequence"]) == ["PEPTIDE"] and back.fragment_df["mz"].tolist() == [1.0, 1.0, 1.0]
    data = Path(alphadia_torch.__file__).parent / "testing" / "data"
    assert len(load_raw_file(data / "hdf_alpharaw_latest.hdf").mz) > 1024  # h5py's libver="latest"
    dia = alphadia_torch.rawdata.DiaData.from_spectra(spectra)
    alphadia_torch.search.plotting.plot_dia_cycle(dia).savefig(Path(d) / "cycle.png", dpi=150)
    assert alphadia_torch.utils.png.read_png(Path(d) / "cycle.png").shape == (450, 1050, 4)
schema = alphadia_torch.gui.schema.build_schema()
assert sum(len(s["parameters"]) for s in schema["config"]) > 80
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("ok")
"""


def test_port_imports_without_jax_or_pandas():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT % str(REPO)],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


_BLOCKED_SEARCH = _BLOCKED_IMPORT.split("import alphadia_torch\n")[0] + """
from pathlib import Path
sys.path.insert(0, %r)
from torch_workflow_worlds import WORLDS, write_search_inputs
from alphadia_torch.search_step import SearchStep
from alphadia_torch.utils.parquet import read_parquet
tmp = Path(%r)
raw_path, lib_path, _, _ = write_search_inputs(tmp, WORLDS["3d"]["world"])
step = SearchStep(str(tmp / "out"), config={**WORLDS["3d"]["config"], "library_path": str(lib_path), "raw_paths": [str(raw_path)]}, device="cpu")
step.run()
assert not step.errors, step.errors
assert len(read_parquet(tmp / "out" / "quant" / "run" / "psm.parquet")["precursor_idx"]) > 100
assert (tmp / "out" / "frozen_config.yaml").exists()
for name in ("precursors.parquet", "pg.matrix.parquet", "stat.tsv", "internal.tsv"):
    assert (tmp / "out" / name).exists(), name
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("ok")
"""


def test_search_step_runs_without_the_blocked_packages(tmp_path):
    """mzML in, TSV library, the search step on the CPU, the per-run parquet
    and the cross-run tables out: no module of the path imports a blocked
    package, lazily or otherwise."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_SEARCH % (str(REPO), str(REPO / "tests"), str(tmp_path))],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


_BLOCKED_PREDICTION = _BLOCKED_IMPORT.split("import alphadia_torch\n")[0] + """
from pathlib import Path
from alphadia_torch.testing.fasta import write_fasta
from alphadia_torch.search_step import SearchStep
fasta = write_fasta(Path(%r) / "db.fasta", 3, seed=2)
step = SearchStep(%r, config={"fasta_paths": [str(fasta)], "library_prediction": {"enabled": True}}, device="cpu")
flat = step.load_library()
assert flat.n_precursors > 100 and float(flat.fragment_df["intensity"].max()) > 0
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("ok")
"""


def test_library_free_build_runs_without_the_blocked_packages(tmp_path):
    """A FASTA digested and predicted with the packaged weights (read by the
    numpy-only unpickler), flattened with decoys: no blocked package."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_PREDICTION % (str(REPO), str(tmp_path), str(tmp_path / "out"))],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


# torch.optim's first optimizer imports torch._dynamo, which asks
# importlib.util.find_spec whether pandas and other optional packages exist
# (None on the card machine, an ImportError from the blocker here): it is
# imported before the blocker goes in
_BLOCKED_FINETUNE = "import torch._dynamo\n" + _BLOCKED_IMPORT.split("import alphadia_torch\n")[0] + """
from pathlib import Path
import numpy as np
from alphadia_torch.models.finetune import FinetuneManager
from alphadia_torch.utils.profiling import profile_trace
tmp = Path(%r)
rng = np.random.default_rng(0)
seqs = np.array(["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), 9)) for _ in range(40)], dtype=object)
psm = {"sequence": seqs, "mods": np.full(40, "", dtype=object), "mod_sites": np.full(40, "", dtype=object),
       "rt_norm": rng.random(40).astype(np.float32), "charge": np.full(40, 2), "mod_seq_hash": np.arange(40),
       "precursor_idx": np.arange(40)}
frag = {"precursor_idx": np.repeat(np.arange(40), 4), "type": np.tile([98, 121], 80), "charge": np.ones(160, np.int64),
        "position": np.tile([0, 0, 1, 1], 40), "intensity": rng.random(160).astype(np.float32)}
with profile_trace(tmp / "prof"):
    mgr = FinetuneManager({"epochs": 2, "batch_size": 8}, device="cpu")
    mgr.finetune_rt(psm)
    mgr.finetune_charge(psm)
    mgr.finetune_ms2(psm, frag)
    assert mgr.finetune_ccs(psm) == {}
mgr.save(tmp / "models")
back = FinetuneManager.load(tmp / "models", device="cpu")
assert np.allclose(back.predict_rt(list(seqs)), mgr.predict_rt(list(seqs)), atol=1e-6)
assert (tmp / "prof" / "trace.json").exists()
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not loaded, loaded
print("ok")
"""


def test_finetune_and_profiling_run_without_the_blocked_packages(tmp_path):
    """The four fits from flax's init drawn without JAX, ``models.pkl``
    written and read again, a profiler trace around them: no blocked
    package."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_FINETUNE % (str(REPO), str(tmp_path))],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


# file-format identifiers the JAX package writes into its HDF files (root
# attribute ``format``); the port writes and reads the same strings
HDF_FORMATS = ("alphadia_tpu_spectra", "alphadia_tpu_speclib_base", "alphadia_tpu_speclib_flat")


def test_port_sources_name_no_jax():
    paths = [p for p in (REPO / "alphadia_torch").rglob("*") if p.suffix in (".py", ".cu", ".cpp")]
    for path in paths + [REPO / "chip_smoke.py"]:
        text = path.read_text()
        for fmt in HDF_FORMATS:
            text = text.replace(f'"{fmt}"', "")
        assert "import jax" not in text and "alphadia_tpu" not in text, path


def test_default_device_raises_without_cuda():
    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.search.selection import CandidateSelection
    from alphadia_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CandidateSelection(DiaData.__new__(DiaData), {}, {})
    assert resolve_device("cpu").type == "cpu"


def test_fdr_and_driver_entry_points_default_to_the_card(tmp_path):
    """The pipelined and RT-windowed drivers, the classifier, the FDR
    manager, the workflow and its extraction handler, the property models'
    manager take ``device=None`` as the card and raise without one."""
    from alphadia_torch.models.classifier import BinaryClassifier
    from alphadia_torch.models.finetune import FinetuneManager
    from alphadia_torch.models.prediction import PACKAGED_MODELS
    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.search.pipelined import PipelinedExtraction
    from alphadia_torch.search.streaming import RtWindowedSearch
    from alphadia_torch.workflow.managers.fdr_manager import FDRManager

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    from alphadia_torch.config import load_default_config
    from alphadia_torch.parallel.distributed import local_devices
    from alphadia_torch.search_step import SearchStep
    from alphadia_torch.workflow.peptidecentric.extraction_handler import ExtractionHandler
    from alphadia_torch.workflow.peptidecentric.peptidecentric import PeptideCentricWorkflow

    for make in (
        lambda: BinaryClassifier(),
        lambda: FDRManager(["a"]),
        lambda: PeptideCentricWorkflow("run", load_default_config(), quant_path=str(tmp_path)),
        lambda: ExtractionHandler(load_default_config(), None, None),
        lambda: PipelinedExtraction(DiaData.__new__(DiaData), {}, {}),
        lambda: RtWindowedSearch(None, {}, {}),
        lambda: SearchStep(str(tmp_path / "step")),
        lambda: local_devices(),
        lambda: FinetuneManager.load(PACKAGED_MODELS),
        lambda: FinetuneManager({"epochs": 1}),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert BinaryClassifier(device="cpu").device.type == "cpu"


def test_device_arrays_default_is_the_card():
    """``DiaData.device_arrays`` follows the device rule of the entry points:
    no device means the card, and without one it raises."""
    from alphadia_torch.rawdata import DiaData
    from alphadia_torch.testing.synthetic import SyntheticConfig, make_synthetic_dia

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    spectra, _, _ = make_synthetic_dia(SyntheticConfig(n_peptides=10, n_windows=2, n_cycles=20))
    dia = DiaData.from_spectra(spectra)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dia.device_arrays()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dia.device_arrays(2)
    assert dia.device_arrays(1, "cpu")["peak_store"].packed.device.type == "cpu"


def test_tf32_is_off():
    import alphadia_torch.utils.device  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
