"""Native libraries of ``alphadia_torch/csrc``, built at first use.

A library is compiled with the host's C++ compiler (``c++`` or ``g++`` on
``PATH``), or with the compiler a caller names (nvcc for the scan-resolved
kernel, ``ops/scan_cells_cuda``), into ``build/alphadia_torch/`` (the XIC
kernel's build directory, ``ALPHADIA_TORCH_BUILD_DIR`` where set), named
by a hash of its source and flags, and replaced atomically, so processes
that build at once do not race. Without a compiler, or when the build
fails, it raises: the port has no other path.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from alphadia_torch.ops.xic_cuda import build_dir


def compiler(what: str) -> str:
    for name in ("c++", "g++"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError(f"no C++ compiler (c++ or g++) on PATH: {what}")


def build_library(source: Path, flags: list[str], stem: str, what: str, cc: str | None = None) -> Path:
    """Compile ``source`` once per content and flags into
    ``<build dir>/<stem>_<hash>.so`` with ``cc`` (the host's C++ compiler
    by default); return its path. ``what`` names the library in errors."""
    digest = hashlib.sha1(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    out = build_dir() / f"{stem}_{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cxx = cc or compiler(f"{what} is built from csrc/{source.name}")
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {what} failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out
