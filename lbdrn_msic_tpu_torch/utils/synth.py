"""Synthetic Gaofen-like multispectral test imagery.

The reference's fixture (`data/sample.tif`, the 2048x2048 crop of the GF-2 A
scene per reference visu_image.py:38) is an LFS blob absent from the
snapshot, so tests and benchmarks here synthesize statistically similar
imagery: 16-bit containers with 10/12-bit effective depth, strong spatial
correlation (terrain-like low-frequency structure), inter-band correlation,
and sensor noise in the low bits.
"""

from __future__ import annotations

import numpy as np


def synth_scene(
    height: int = 512,
    width: int = 512,
    channels: int = 4,
    effective_bits: int = 12,
    seed: int = 0,
    fast: bool = False,
) -> np.ndarray:
    """Return a CHW uint16 synthetic multispectral scene.

    Built as a sum of smooth octaves (spatially correlated "terrain") shared
    across bands plus band-specific detail and per-pixel noise, scaled into
    the effective bit depth.

    ``fast=True`` runs the identical construction in float32 with
    single-precision noise draws — ~5x faster on full-size Gaofen scenes
    (the float64 path moves ~50 GB of memory per 57-Mpx scene), with the
    same spatial/band statistics but different sample values.  Tests and
    committed fixtures use the default path (values stable); the flagship
    workload synthesizer uses ``fast``.
    """
    rng = np.random.default_rng(seed)
    ftype = np.float32 if fast else np.float64
    base = np.zeros((height, width), dtype=ftype)
    # octave noise via nearest upsampling of coarse grids + box smoothing
    amp = 1.0
    size = 4
    while size <= min(height, width):
        coarse = rng.standard_normal((size, size)).astype(ftype)
        reps_h = -(-height // size)
        reps_w = -(-width // size)
        # exact kron-with-ones, without materializing outer products
        up = np.repeat(
            np.repeat(coarse, reps_h, axis=0), reps_w, axis=1
        )[:height, :width]
        # cheap smoothing: two passes of 3x3 box via cumsum-free shifts
        for _ in range(2):
            up = (
                up
                + np.roll(up, 1, 0) + np.roll(up, -1, 0)
                + np.roll(up, 1, 1) + np.roll(up, -1, 1)
            ) / 5.0
        base += (amp * up).astype(ftype)
        amp *= 0.55
        size *= 2
    base = (base - base.min()) / (base.max() - base.min() + 1e-9)

    peak = (1 << effective_bits) - 1
    out = np.zeros((channels, height, width), dtype=np.uint16)
    for c in range(channels):
        gain = 0.55 + 0.4 * rng.random()
        offset = 0.03 + 0.1 * rng.random()
        if fast:
            detail = rng.standard_normal(
                (height, width), dtype=np.float32
            ) * np.float32(0.004)
            band = np.clip(offset + gain * base + detail, 0.0, 1.0)
            noise = rng.standard_normal(
                (height, width), dtype=np.float32
            ) * np.float32(2.0)
            vals = band * peak + noise
        else:
            detail = rng.standard_normal((height, width)) * 0.004
            band = np.clip(offset + gain * base + detail, 0.0, 1.0)
            vals = band * peak + rng.normal(0.0, 2.0, (height, width))
        out[c] = np.clip(np.rint(vals), 0, peak).astype(np.uint16)
    return out
