"""DIA cycle detection.

The cycle signature of a spectrum sequence is ``isolation_lower_mz +
isolation_upper_mz`` (MS1 spectra carry -1/-1). The cycle length is the lag
of the highest local maximum of the signature's normalized autocorrelation;
the cycle start is the first index where a window of one cycle length is
non-constant and equals the following window; the cycle must then repeat
identically. The result is a ``(1, cycle_len, 1, 2)`` float64 array of
isolation bounds.
"""

from __future__ import annotations

import numpy as np


class NotDiaDataError(ValueError):
    """The raw file is not a valid DIA acquisition."""


def _normed_autocorrelation(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    n = len(x)
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft)
    corr = np.fft.irfft(f * np.conj(f), nfft)[:n]
    if corr[0] == 0:
        return np.ones_like(corr)
    return corr / corr[0]


def _get_cycle_length(signature: np.ndarray) -> int:
    corr = _normed_autocorrelation(signature)
    if len(corr) < 3:
        return -1
    is_peak = (corr[1:-1] > corr[:-2]) & (corr[1:-1] > corr[2:])
    peak_idx = np.nonzero(is_peak)[0] + 1
    if len(peak_idx) == 0:
        return -1
    return int(peak_idx[np.argmax(corr[peak_idx])])


def _get_cycle_start(signature: np.ndarray, cycle_length: int) -> int:
    limit = len(signature) - 2 * cycle_length
    if limit <= 0:
        return -1
    windows = np.lib.stride_tricks.sliding_window_view(signature, cycle_length)
    constant = np.all(windows[:limit] == signature[:limit, None], axis=1)
    repeats = np.all(
        windows[:limit] == windows[cycle_length : limit + cycle_length], axis=1
    )
    ok = np.nonzero(~constant & repeats)[0]
    return int(ok[0]) if len(ok) else -1


def _is_valid_cycle(signature: np.ndarray, cycle_length: int, cycle_start: int) -> bool:
    sig = signature[cycle_start:]
    n_full = len(sig) // cycle_length
    if n_full < 2:
        return False
    tiles = sig[: n_full * cycle_length].reshape(n_full, cycle_length)
    return bool(np.all(tiles == tiles[0]))


def determine_dia_cycle(
    rt: np.ndarray,
    isolation_lower_mz: np.ndarray,
    isolation_upper_mz: np.ndarray,
    subset_for_cycle_detection: int = 10000,
) -> tuple[np.ndarray, int, int]:
    """Returns (cycle array of shape (1, cycle_len, 1, 2), cycle_start, cycle_len)."""
    signature = np.asarray(
        isolation_lower_mz[:subset_for_cycle_detection], dtype=np.float64
    ) + np.asarray(isolation_upper_mz[:subset_for_cycle_detection], dtype=np.float64)

    cycle_length = _get_cycle_length(signature)
    if cycle_length <= 0:
        raise NotDiaDataError("Failed to determine length of DIA cycle.")
    cycle_start = _get_cycle_start(signature, cycle_length)
    if cycle_start < 0:
        raise NotDiaDataError("Failed to determine start of DIA cycle.")
    if not _is_valid_cycle(signature, cycle_length, cycle_start):
        raise NotDiaDataError(
            f"Cycle with start {rt[cycle_start]:.2f} and length {cycle_length} "
            "detected, but is not consistent."
        )

    cycle = np.zeros((1, cycle_length, 1, 2), dtype=np.float64)
    cycle[0, :, 0, 0] = isolation_lower_mz[cycle_start : cycle_start + cycle_length]
    cycle[0, :, 0, 1] = isolation_upper_mz[cycle_start : cycle_start + cycle_length]
    return cycle, cycle_start, cycle_length
