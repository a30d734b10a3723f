# Frozen copy of alphadia_torch/ops/smooth.py, lines 1-40, at commit b5dd55e, imports
# rewritten to this package; the plain reference of the benchmark. Edits below
# the copy are marked "reference:".
"""Gaussian smoothing of XIC profiles.

The kernel follows the reference GaussianKernel (sigma acts as covariance);
the convolution is centre-aligned at ``kernel_size // 2`` and runs as one
float32 product with a banded Toeplitz matrix (TF32 is off, see
``utils/device.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    """w(x) = (2 pi)^(-1/2) sigma^(-1/2) exp(-x^2 / (2 sigma)),
    x in [-size//2, size//2)."""
    x = np.arange(-size // 2, size // 2, dtype=np.float64)
    b = (2 * np.pi) ** (-0.5) * max(sigma, 1e-12) ** (-0.5)
    return (b * np.exp(-(x**2) / (2.0 * max(sigma, 1e-12)))).astype(np.float32)


def rt_kernel_sigma(fwhm_rt: float, sigma_scale_rt: float, cycle_time: float) -> float:
    return (fwhm_rt / 2.3548) * sigma_scale_rt / max(cycle_time, 1e-9)


def convolve_profiles(profiles: torch.Tensor, kernel: torch.Tensor, *, kernel_size: int):
    """Convolve [..., W] profiles with a 1D kernel:
    out[i] = sum_t kernel[t] * x[i + t - kernel_size // 2]."""
    shape = profiles.shape
    W = shape[-1]
    dev = profiles.device
    i = torch.arange(W, device=dev)[None, :]
    j = torch.arange(W, device=dev)[:, None]
    t = j - i + kernel_size // 2
    # band[j, i] = kernel[j - i + centre]: rows are sources, columns outputs
    band = torch.where(
        (t >= 0) & (t < kernel_size), kernel[t.clamp(0, kernel_size - 1)], 0.0
    )
    return (profiles.reshape(-1, W) @ band).reshape(shape)
