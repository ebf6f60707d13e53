"""Rate-distortion metrics.

PSNR uses the reference's fixed peak of 10000 (reference decode.py:218,
SOTA.py:187, DLPR_nll.py:46) — the nominal radiometric ceiling of the
Gaofen products — not the per-image max.  BD metrics follow the classical
Bjontegaard cubic log-rate fit exactly as implemented at
reference BD_metrics.py:8-70 (including the optional piecewise-cubic mode),
as the JAX package computes them.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate

PSNR_PEAK = 10000.0
# numpy 2 renamed trapz; either gives the same sum
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


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


def bd_rate(rate_anchor, psnr_anchor, rate_test, psnr_test, piecewise=False) -> float:
    """Bjontegaard delta-rate (%) of test vs anchor (negative = test better)."""
    lr_a = np.log(np.asarray(rate_anchor, dtype=np.float64))
    lr_t = np.log(np.asarray(rate_test, dtype=np.float64))
    pa = np.asarray(psnr_anchor, dtype=np.float64)
    pt = np.asarray(psnr_test, dtype=np.float64)

    lo = max(pa.min(), pt.min())
    hi = min(pa.max(), pt.max())
    if piecewise:
        # sampled-trapezoid pchip integral, as the reference does
        # (BD_metrics.py:58-65, after webm's visual_metrics.py)
        samples, interval = np.linspace(lo, hi, num=100, retstep=True)
        ia = np.argsort(pa)
        it = np.argsort(pt)
        va = _trapezoid(
            scipy.interpolate.pchip_interpolate(pa[ia], lr_a[ia], samples), dx=interval
        )
        vt = _trapezoid(
            scipy.interpolate.pchip_interpolate(pt[it], lr_t[it], samples), dx=interval
        )
    else:
        ca = np.polyfit(pa, lr_a, 3)
        ct = np.polyfit(pt, lr_t, 3)
        va = np.polyval(np.polyint(ca), hi) - np.polyval(np.polyint(ca), lo)
        vt = np.polyval(np.polyint(ct), hi) - np.polyval(np.polyint(ct), lo)
    avg_exp_diff = (vt - va) / (hi - lo)
    return float((np.exp(avg_exp_diff) - 1) * 100)


def bd_psnr(rate_anchor, psnr_anchor, rate_test, psnr_test, piecewise=False) -> float:
    """Bjontegaard delta-PSNR (dB) of test vs anchor (positive = test better)."""
    lr_a = np.log(np.asarray(rate_anchor, dtype=np.float64))
    lr_t = np.log(np.asarray(rate_test, dtype=np.float64))
    pa = np.asarray(psnr_anchor, dtype=np.float64)
    pt = np.asarray(psnr_test, dtype=np.float64)

    lo = max(lr_a.min(), lr_t.min())
    hi = min(lr_a.max(), lr_t.max())
    if piecewise:
        samples, interval = np.linspace(lo, hi, num=100, retstep=True)
        ia = np.argsort(lr_a)
        it = np.argsort(lr_t)
        va = _trapezoid(
            scipy.interpolate.pchip_interpolate(lr_a[ia], pa[ia], samples), dx=interval
        )
        vt = _trapezoid(
            scipy.interpolate.pchip_interpolate(lr_t[it], pt[it], samples), dx=interval
        )
    else:
        ca = np.polyfit(lr_a, pa, 3)
        ct = np.polyfit(lr_t, pt, 3)
        va = np.polyval(np.polyint(ca), hi) - np.polyval(np.polyint(ca), lo)
        vt = np.polyval(np.polyint(ct), hi) - np.polyval(np.polyint(ct), lo)
    return float((vt - va) / (hi - lo))
