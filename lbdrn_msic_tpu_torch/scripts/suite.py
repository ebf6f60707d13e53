"""What the validation scripts share: the synthetic Gaofen-like suite, one
stream's RD point, the canonical results CSV and the name of the device a
study ran on.

The JAX package repeats these lines in each script (rd_validation.py,
recipe_study.py, ablations.py); the port keeps them once.  Every number
is computed as the JAX scripts compute it, so the CSVs are theirs
character for character on the same streams.
"""

from __future__ import annotations

import csv
import subprocess

import numpy as np

METRICS = ["MSE", "PSNR", "bpsp", "bits"]
# where the port's studies write by default: git-ignored, and never the
# JAX package's record in validation/
OUT_DEFAULT = "out/validation"


def synth_suite(size: int, scenes: int, channels: int = 4) -> dict:
    """{"scene<i>": (C, size, size) uint16}, 12-bit, seeds 100 + i (the JAX
    scripts' suite)."""
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene

    return {
        f"scene{i}": synth_scene(size, size, channels, effective_bits=12, seed=100 + i)
        for i in range(scenes)
    }


def rd_point(img: np.ndarray, stream: bytes, K: int, device) -> tuple[list, bool]:
    """Decode `stream`: ([MSE, PSNR, bpsp, bits], MSBs exact?)."""
    from lbdrn_msic_tpu_torch.codec import decode_stream
    from lbdrn_msic_tpu_torch.eval.metrics import PSNR_PEAK

    rec, _ = decode_stream(stream, device=device)
    mse = float(np.mean((img.astype(np.float32) - rec.astype(np.float32)) ** 2))
    psnr = 10 * np.log10(PSNR_PEAK**2 / mse) if mse else float("inf")
    bits = 8 * len(stream)
    return [mse, psnr, bits / img.size, bits], bool(np.array_equal(rec >> K, img >> K))


def write_rd_csv(path: str, names, ks, rd: dict) -> str:
    """Rows K<k>, columns {name}_{MSE,PSNR,bpsp,bits}; rd[(K, name)] is a
    `rd_point` row."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["K"] + [f"{n}_{m}" for n in names for m in METRICS])
        for K in ks:
            w.writerow([f"K{K}"] + [v for n in names for v in rd[(K, n)]])
    return path


def device_label(device) -> str:
    """"one <card>, <power limit>" as nvidia-smi reports them, or "the CPU"."""
    if device.type != "cuda":
        return "the CPU"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, stdout=subprocess.PIPE, text=True, timeout=60,
        ).stdout.strip().splitlines()
        return f"one {out[device.index or 0]}"
    except (OSError, subprocess.SubprocessError, IndexError):
        import torch

        return f"one {torch.cuda.get_device_name(device)}"
