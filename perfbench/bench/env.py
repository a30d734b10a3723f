"""The environment of a run: every build and kernel cache of the program
inside the checkout at fixed paths, and no library loading JAX by itself."""

import os
from pathlib import Path

CACHE = Path(__file__).resolve().parents[1] / ".cache"


def setup():
    os.environ["ALPHADIA_TORCH_BUILD_DIR"] = str(CACHE / "build")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
