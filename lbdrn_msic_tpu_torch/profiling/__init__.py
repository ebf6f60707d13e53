"""Profiling counterparts of the JAX package's scripts/profiling/: the
step-anatomy probes (K5, `kernel_prof`), where the encode's train time goes
(`step_prof`), the bf16 product A/B (`mm_ab`), expert-batched
utilisation (`mfu_experts`) and the multi-step chunk A/B (`multik_ab`).
Each runs as `python -m lbdrn_msic_tpu_torch.profiling.<name>` on a CUDA
card and prints what its JAX script prints; nothing here falls back to the
CPU (`multik_ab` runs on the CPU only when given `--device cpu`).

`PEAKS`: an H100's published dense rates (NVIDIA data sheets, at the full
power limit), the yardsticks of every bound and utilisation the port
reports: f32 on the CUDA cores, TF32 and bf16 on the tensor cores, HBM
bandwidth.
"""

from __future__ import annotations

import time

import torch

PEAKS = {
    "sxm": {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "hbm": 3.35e12},
    "pcie": {"f32": 51e12, "tf32": 378e12, "bf16": 756e12, "hbm": 2.0e12},
}


def peaks(card_name: str) -> dict:
    """The PEAKS row of a card, by its name (H100 PCIe, else SXM)."""
    return PEAKS["pcie" if "PCIE" in card_name.upper() else "sxm"]


def timed(label: str, fn, n: int = 3) -> float:
    """Best host-clock seconds of n calls of fn, each ended by a device
    synchronize; prints `label: ms` as the JAX scripts do."""
    best = float("inf")
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.time() - t0)
    print(f"{label:>16}: {best * 1e3:9.1f} ms", flush=True)
    return best
