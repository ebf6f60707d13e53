"""Host -> device image transfer.

A pinned, non-blocking copy: bit-identical to the host array by
construction.  (The JAX package delta-codes uint16 images for a slow
remote link; PCIe to a local card needs no such coding.)
"""

from __future__ import annotations

import numpy as np
import torch


def put_image(img: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host array to `device`; uint16 becomes int32 (torch has few
    uint16 ops), uint8 stays uint8.  Asynchronous on CUDA."""
    arr = np.ascontiguousarray(img)
    wide = arr.dtype == np.uint16
    t = torch.from_numpy(arr.view(np.int16) if wide else arr)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    # the 16-bit payload crosses the link; widening happens on the device
    return (t.to(torch.int32) & 0xFFFF) if wide else t
