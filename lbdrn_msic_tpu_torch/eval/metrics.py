"""Rate-distortion metrics.

PSNR uses the reference's fixed peak of 10000 (reference decode.py:218) —
the nominal radiometric ceiling of the Gaofen products — not the per-image
max.
"""

from __future__ import annotations

import numpy as np

PSNR_PEAK = 10000.0


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((a.astype(np.float32) - b.astype(np.float32)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = PSNR_PEAK) -> float:
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(peak**2 / m))


def bpsp(n_bytes: int, shape) -> float:
    """Bits per subpixel: total bits / (C*H*W)."""
    return n_bytes * 8 / float(np.prod(shape))
