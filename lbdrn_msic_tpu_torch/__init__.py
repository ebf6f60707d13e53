"""PyTorch/CUDA port of the LBDRN multispectral image codec.

The JAX package `lbdrn_msic_tpu` is the reference this port is held
against; this package imports nothing of it (and no JAX).  Entry points
take `device=None`, which means CUDA: they run on the CPU only when the
caller passes `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA device; raises when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
