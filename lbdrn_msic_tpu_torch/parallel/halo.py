"""Spatially sharded decoding over the mesh's "dp" axis (the JAX package's
`parallel/halo.py`).

The image's rows are split into one band per rank; each rank reconstructs
its band and the bands are gathered, so every rank returns the whole
image, bit-identical to the single-card decode.  A pixel's features read
its (2D+1)^2 neighbourhood, so a band needs D rows of halo on each side.
The JAX package shards the base over its devices and trades the halos
with ring shifts; here every rank already holds the whole decoded base
(as the JAX function's `base` input is whole), so a rank slices its band
with its halo from it (`decode/reconstruct._band_halo`, whose edge halos
reflect) and no halo crosses ranks.  What crosses is the K residual
bitplanes of each band, one gather.
"""

from __future__ import annotations

import numpy as np
import torch

from lbdrn_msic_tpu_torch import resolve_device
from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec
from lbdrn_msic_tpu_torch.decode.reconstruct import (
    _assemble_band,
    _band_halo,
    _residual_band_planes,
    _residual_band_planes_local,
)
from lbdrn_msic_tpu_torch.features.engine import pad_plane
from lbdrn_msic_tpu_torch.models.siren import SirenParams
from lbdrn_msic_tpu_torch.parallel.distributed import collect
from lbdrn_msic_tpu_torch.parallel.shard import axis_rank, axis_size
from lbdrn_msic_tpu_torch.utils.transfer import put_image


def reconstruct_sp(mesh, base: np.ndarray, params: SirenParams, fspec: FeatureSpec,
                   mspec: ModelSpec, K: int, device=None) -> np.ndarray:
    """Row-sharded reconstruction over the mesh's "sp" (= "dp") axis.

    base: the whole (C, H, W) decoded base layer, on every rank, with H
    divisible by the axis size.  The rank at coordinate i computes the
    residual bitplanes of rows [i * H/n, (i + 1) * H/n): colour features
    from its band with a D-row halo and the plane scale of the WHOLE base
    (float32(1) / float32(max(base.max(), 1)), as the single-card decode);
    coordinate features from the whole padded plane with global row
    indices.  The forward uses the exact `sin`.  After one gather of the
    bitplanes every rank assembles the same (C, H, W) uint16 image."""
    dev = resolve_device(device)
    n, me = axis_size(mesh, "dp"), axis_rank(mesh, "dp")
    C, H, W = base.shape
    if H % n != 0:
        raise ValueError(f"H={H} must divide over {n} shards")
    Hl = H // n
    with torch.no_grad():
        if fspec.use_coords:
            plane, scale = pad_plane(put_image(base, dev), fspec.D)
            planes = _residual_band_planes(plane, scale, params, me * Hl, fspec, mspec, K, H, W,
                                           Hl)
        else:
            scale = torch.tensor(np.float32(1.0) / np.float32(max(int(base.max()), 1)),
                                 device=dev)
            band = put_image(_band_halo(base, me * Hl, Hl, fspec.D), dev)
            planes = _residual_band_planes_local(band, params, scale, fspec, mspec, K, W, Hl)
        got = collect(planes, mesh.get_group("dp"), op="gather").cpu().numpy()
    out = np.empty((C, H, W), np.uint16)
    for i in range(n):
        blk = np.ascontiguousarray(base[:, i * Hl : (i + 1) * Hl])
        out[:, i * Hl : (i + 1) * Hl] = _assemble_band(list(got[i]), blk, K)
    return out
