"""Visualization utilities (role of reference visu_image.py:11-383).

MSB/LSB bit-plane views, RGB / false-color composites for 4- and 8-band
Gaofen products, and error-map grids comparing reconstructions across
methods.  All figures go through matplotlib's Agg backend (file output
only, no display server needed), imported by the functions that draw:
the module imports without matplotlib, and `composite` needs none.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _stretch(band: np.ndarray, p_lo=2, p_hi=98) -> np.ndarray:
    lo, hi = np.percentile(band, [p_lo, p_hi])
    return np.clip((band.astype(np.float64) - lo) / max(hi - lo, 1e-9), 0, 1)


def composite(img: np.ndarray, bands: Sequence[int]) -> np.ndarray:
    """(C,H,W) -> (H,W,3) percentile-stretched composite.

    Gaofen MS band order is B,G,R,NIR (reference visu_image.py Gaofen2):
    true color = bands (2,1,0), false color (NIR) = (3,2,1).
    """
    return np.stack([_stretch(img[b]) for b in bands], axis=-1)


def save_composite(img: np.ndarray, out_png: str, bands=(2, 1, 0)) -> str:
    _pyplot().imsave(out_png, composite(img, bands))
    return out_png


def msb_lsb_figure(img: np.ndarray, K: int, out_png: str, band: int = 0) -> str:
    """Side-by-side original / MSB / LSB views of one band
    (reference visu_image.py MSB_LSB)."""
    plt = _pyplot()
    msb = img[band] >> K
    lsb = img[band] - (msb << K)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, (data, title) in zip(
        axes,
        [(img[band], "original"), (msb, f"MSB (>>{K})"), (lsb, f"LSB ({K} bits)")],
    ):
        ax.imshow(_stretch(data), cmap="gray")
        ax.set_title(title)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def error_map_grid(
    org: np.ndarray,
    recons: Dict[str, np.ndarray],
    out_png: str,
    band: Optional[int] = None,
    vmax: Optional[float] = None,
) -> str:
    """|recon - org| heat maps, one panel per method
    (reference visu_image.py error_map_*)."""
    plt = _pyplot()
    n = len(recons)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4), squeeze=False)
    errs = {}
    for name, rec in recons.items():
        e = np.abs(rec.astype(np.int32) - org.astype(np.int32))
        errs[name] = e[band] if band is not None else e.mean(axis=0)
    if vmax is None:
        vmax = max(float(e.max()) for e in errs.values()) or 1.0
    for ax, (name, e) in zip(axes[0], errs.items()):
        im = ax.imshow(e, cmap="inferno", vmin=0, vmax=vmax)
        ax.set_title(name)
        ax.axis("off")
    fig.colorbar(im, ax=list(axes[0]), shrink=0.8)
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_png
