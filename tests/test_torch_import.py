"""The port imports without JAX, the JAX package or pandas, and its entry
points refuse to run on a missing card unless the CPU is asked for."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytest_plugins = ("torch_port_plugin",)

REPO = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = """
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "alphadia_tpu", "pandas")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
import alphadia_torch
import alphadia_torch.convert
import alphadia_torch.ops.scoring
import alphadia_torch.ops.selection
import alphadia_torch.search.common
import alphadia_torch.search.scoring
import alphadia_torch.search.selection
import alphadia_torch.testing.synthetic
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


def test_port_sources_name_no_jax():
    paths = [p for p in (REPO / "alphadia_torch").rglob("*") if p.suffix in (".py", ".cu")]
    for path in paths + [REPO / "chip_smoke.py"]:
        text = path.read_text()
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


def test_tf32_is_off():
    import alphadia_torch.utils.device  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
