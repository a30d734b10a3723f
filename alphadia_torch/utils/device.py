"""Device policy and shape helpers.

Entry points take ``device=None``, meaning the CUDA card. Without a card
they raise unless the caller asked for ``"cpu"`` explicitly: the port never
falls back silently, so a measurement can never come from the wrong device.

TF32 is switched off for matrix products and convolutions: the band-matrix
smoothing of selection is a float32 product, and TF32's 10-bit mantissa
would move the selection scores.

``deterministic(device)`` holds PyTorch's deterministic algorithms on for a
span on the card: a training loop in it reads the same weights in every
run (the default backward passes on the card sum in an order that varies
from run to run).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# bucket grid for cycle-window lengths (powers of two)
WINDOW_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the host"
        )
    return dev


@contextmanager
def deterministic(device):
    """PyTorch's deterministic algorithms for the span when ``device`` is a
    CUDA device (the CPU's kernels already are); the setting before is put
    back after."""
    if torch.device(device).type != "cuda":
        yield
        return
    before = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def effective_batch(configured: int, n: int, floor: int = 256) -> int:
    """The configured cap, shrunk to the next power of two >= n."""
    b = floor
    while b < n and b < configured:
        b *= 2
    return min(b, configured)


def batch_schedule(n: int, cap: int, floor: int = 256) -> list[tuple[int, int]]:
    """Greedy power-of-two batch decomposition ``[(start, batch_size), ...]``.

    The batch size halves toward the tail whenever the remainder would fill
    less than three quarters of a batch.
    """
    if n <= 0:
        return []
    bsz = effective_batch(cap, n, floor)
    out = []
    b0 = 0
    while b0 < n:
        rem = n - b0
        while bsz > floor and rem < (3 * bsz) // 4:
            bsz //= 2
        out.append((b0, bsz))
        b0 += min(bsz, rem)
    return out


def bucket_window(n: int) -> int:
    """Round a window length up to the bucket grid."""
    for b in WINDOW_BUCKETS:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def bucket_count(n: int, minimum: int = 4096) -> int:
    """Round an array length up to a quarter-power-of-two bucket."""
    n = max(int(n), minimum)
    k = 1 << (n.bit_length() - 1)
    step = max(k // 4, 1)
    return ((n + step - 1) // step) * step
