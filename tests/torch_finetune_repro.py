"""Reads whether a fine-tune on the card gives the same weights twice, three
ways:

- ``default``: the training steps with PyTorch's default kernels (the
  deterministic span of ``utils/device.deterministic`` replaced by one that
  does nothing);
- ``cudnn_deterministic``: the same with only ``torch.backends.cudnn``'s
  deterministic flag set;
- ``port``: the port's fit, its training steps under PyTorch's
  deterministic algorithms.

Each way fits rt, charge and ms2 twice from the same config and random
state on the seeded PSMs of ``tests/test_torch_gpu._finetune_inputs`` (2,400
PSMs of 1,200 peptides) at the default training settings, and prints the
largest weight difference between the two fits of each model and the
seconds of the fits. Usage, on the card:

    python3 tests/torch_finetune_repro.py
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
MODELS = ("rt", "charge", "ms2")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def fits(psm, frag) -> tuple[dict, float]:
    import torch

    from alphadia_torch.models.finetune import FinetuneManager

    mgr = FinetuneManager(None, random_state=0, device="cuda")
    t0 = time.perf_counter()
    for name in MODELS:
        getattr(mgr, f"finetune_{name}")(*((psm, frag) if name == "ms2" else (psm,)))
    torch.cuda.synchronize()
    weights = {n: {k: v.cpu().numpy() for k, v in m.state_dict().items()} for n, m in mgr.models.items()}
    return weights, time.perf_counter() - t0


def main() -> int:
    import torch

    from alphadia_torch.models import finetune
    from test_torch_gpu import _finetune_inputs

    if not torch.cuda.is_available():
        print("torch_finetune_repro: needs a CUDA card", file=sys.stderr)
        return 2
    card = card_line()
    psm, frag = _finetune_inputs(n=1200)
    port_span = finetune.deterministic
    ways = {
        "default": (lambda device: contextlib.nullcontext(), {}),
        "cudnn_deterministic": (lambda device: contextlib.nullcontext(), {"deterministic": True}),
        "port": (port_span, {}),
    }
    for way, (span, cudnn) in ways.items():
        finetune.deterministic = span
        try:
            with torch.backends.cudnn.flags(enabled=True, benchmark=False, allow_tf32=False,
                                            deterministic=cudnn.get("deterministic", False)):
                (w0, s0), (w1, s1) = fits(psm, frag), fits(psm, frag)
        finally:
            finetune.deterministic = port_span
        diff = {n: max(float(np.abs(w0[n][k] - w1[n][k]).max()) for k in w0[n]) for n in w0}
        print(f"{way}: largest weight difference between two fits {json.dumps(diff)}; "
              f"fits {s0:.4f} s and {s1:.4f} s ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
