"""Image quality metrics: MSE and PSNR (numpy, host side)."""

from __future__ import annotations

import numpy as np


def mse(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(np.mean((a - b) ** 2))


def psnr(x: np.ndarray, ref: np.ndarray, data_range: float | None = None) -> float:
    """PSNR in dB; ``data_range`` defaults to the reference's max - min."""
    err = mse(x, ref)
    if data_range is None:
        data_range = float(np.asarray(ref).max() - np.asarray(ref).min())
    if err == 0:
        return float("inf")
    return float(20.0 * np.log10(data_range) - 10.0 * np.log10(err))
