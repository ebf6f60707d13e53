"""Frozen copies of the port's measurement arithmetic, kept with the
benchmark so that a change to the program cannot move the yardstick.

Each function names the file of `lbdrn_msic_tpu_torch` (or the repo root)
it was copied from, at commit 4cadcd2.  They import nothing of the port.
"""

from __future__ import annotations

import subprocess

import numpy as np


def synth_scene(height: int, width: int, channels: int = 4, effective_bits: int = 12,
                seed: int = 0, fast: bool = True) -> np.ndarray:
    """A CHW uint16 synthetic multispectral scene: smooth octaves shared
    across bands, band gain and offset, band detail and sensor noise, at
    `effective_bits`.  Copied from lbdrn_msic_tpu_torch/utils/synth.py
    (`synth_scene`, commit 4cadcd2); the benchmark uses the `fast`
    (float32) construction."""
    rng = np.random.default_rng(seed)
    ftype = np.float32 if fast else np.float64
    base = np.zeros((height, width), dtype=ftype)
    amp = 1.0
    size = 4
    while size <= min(height, width):
        coarse = rng.standard_normal((size, size)).astype(ftype)
        reps_h = -(-height // size)
        reps_w = -(-width // size)
        up = np.repeat(np.repeat(coarse, reps_h, axis=0), reps_w, axis=1)[:height, :width]
        for _ in range(2):
            up = (up + np.roll(up, 1, 0) + np.roll(up, -1, 0)
                  + np.roll(up, 1, 1) + np.roll(up, -1, 1)) / 5.0
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
            detail = rng.standard_normal((height, width), dtype=np.float32) * np.float32(0.004)
            band = np.clip(offset + gain * base + detail, 0.0, 1.0)
            noise = rng.standard_normal((height, width), dtype=np.float32) * np.float32(2.0)
            vals = band * peak + noise
        else:
            detail = rng.standard_normal((height, width)) * 0.004
            band = np.clip(offset + gain * base + detail, 0.0, 1.0)
            vals = band * peak + rng.normal(0.0, 2.0, (height, width))
        out[c] = np.clip(np.rint(vals), 0, peak).astype(np.uint16)
    return out


def step_cost(B: int, dims, P: int):
    """(operations, bytes) one fused training step needs: the matmuls
    (forward, dW, dH for layers >= 1), ~26 ops per hidden activation for
    sincos, ~12 per parameter for Adam; x/y/mask read once, params/m/v read
    and written.  Copied from chip_smoke.py (`step_cost`, commit 4cadcd2).
    The benchmark passes the real input width (C * (2D+1)^2), not the
    kernel's padded one."""
    L = len(dims) - 1
    mm = sum(dims[l] * dims[l + 1] for l in range(L))
    mm_dh = sum(dims[l] * dims[l + 1] for l in range(1, L))
    ops = 2 * B * (2 * mm + mm_dh) + 26 * B * sum(dims[1:L]) + 12 * P
    nbytes = 4 * (B * dims[0] + B * dims[-1] + B) + 4 * 6 * P + 4
    return ops, nbytes


def forward_ops(N: int, dims) -> int:
    """Operations of one forward pass over N rows: the matmuls and ~13 ops
    per hidden activation (one sin: half of `step_cost`'s sincos)."""
    L = len(dims) - 1
    mm = sum(dims[l] * dims[l + 1] for l in range(L))
    return 2 * N * mm + 13 * N * sum(dims[1:L])


def param_count(dims) -> int:
    return sum((dims[l] + 1) * dims[l + 1] for l in range(len(dims) - 1))


def busy_union(spans) -> float:
    """Length of the union of (start, end) intervals, in their unit: the
    time in which the device ran at least one operation (a sum would count
    twice the time in which a programmatic dependent launch overlaps its
    primary).  Copied from chip_smoke.py (`busy_seconds`, commit 4cadcd2),
    taking the intervals instead of the profiler."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


# an H100's published dense rates at the full power limit (NVIDIA data
# sheets): f32 on the CUDA cores, TF32 and bf16 on the tensor cores, HBM
# bandwidth.  Copied from lbdrn_msic_tpu_torch/profiling/__init__.py
# (`PEAKS`, `peaks`, commit 4cadcd2).
PEAKS = {
    "sxm": {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "hbm": 3.35e12},
    "pcie": {"f32": 51e12, "tf32": 378e12, "bf16": 756e12, "hbm": 2.0e12},
}


def peaks(card_name: str) -> dict:
    """The PEAKS row of a card, by its name (H100 PCIe, else SXM)."""
    return PEAKS["pcie" if "PCIE" in card_name.upper() else "sxm"]


# PSNR at the reference's fixed peak of 10000 (reference decode.py:218).
# Copied from lbdrn_msic_tpu_torch/eval/metrics.py (`PSNR_PEAK`, `mse`,
# `psnr`, `bpsp`, commit 4cadcd2).
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


def device_info(index: int = 0) -> dict:
    """The card's name and power limit as nvidia-smi reports them.  Copied
    from lbdrn_msic_tpu_torch/scripts/bench.py (`device_info`, commit
    4cadcd2), for one card by index."""
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, stdout=subprocess.PIPE, text=True, timeout=60,
    ).stdout.strip().splitlines()
    name, limit = rows[index].rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}
