"""Feature/label engine, cached-staging subset.

Semantics match the reference pipeline (reference LBDRNdataset.py:92-133 /
decode.py:77-102) and are bit-identical to the JAX package's engine: the
engine works in integer tap space — a feature is
``float32(tap - center) * (1/max)`` — with the plane held as int32 (torch
has few uint16 ops).

Feature vector layout per pixel (the reference's ``sliding_window_view``
order, LBDRNdataset.py:119-129): ``[band0: (2D+1)^2 taps row-major, band1:
..., ...]`` with taps optionally center-subtracted (RELATIVE) and
max-normalized.  Coordinate features are not ported yet.

Training batches come from the "cached" staging buffer: every pixel's
final model input row, built once with the slice path
(`build_feature_cache`); a batch is one row gather.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lbdrn_msic_tpu_torch.core.config import FeatureSpec


def split_msb_lsb(img: torch.Tensor, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """MSB/LSB split (reference LBDRNdataset.py:94-97).

    img: (C, H, W) integer tensor holding uint16 values.  Returns (MSB, LSB)
    int32, LSB raw integers in [0, 2^K - 1]."""
    img = img.to(torch.int32)
    msb = img >> K
    return msb, img - (msb << K)


def lsb_scale(K: int) -> float:
    """Label normalizer 1/(2^K - 1) (reference LBDRNdataset.py:96)."""
    return 1.0 / float(2**K - 1)


def reflect_index(n: int, D: int, device=None) -> torch.Tensor:
    """Indices of a length-n axis reflect-padded by D on both sides
    (numpy/jnp ``mode="reflect"``: the edge sample is not repeated)."""
    if D > n - 1:
        raise ValueError(f"reflect pad {D} needs an axis longer than {D} (got {n})")
    idx = torch.arange(-D, n + D, device=device)
    idx = torch.where(idx < 0, -idx, idx)
    return torch.where(idx >= n, 2 * (n - 1) - idx, idx)


def pad_plane(msb: torch.Tensor, D: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reflect-pad the base plane, keeping integers (reference
    LBDRNdataset.py:119-123 does pad(msb/max)).

    msb: (C, H, W) integer base layer.  Returns (int32 (C, H+2D, W+2D),
    float32 0-d scale = 1/max).  A zero plane normalizes by 1."""
    plane = msb.to(torch.int32)
    scale = 1.0 / torch.clamp(plane.max().to(torch.float32), min=1.0)
    if D > 0:
        _, H, W = plane.shape
        plane = plane[:, reflect_index(H, D, plane.device)][
            :, :, reflect_index(W, D, plane.device)
        ]
    return plane, scale


def _block_taps_int(plane: torch.Tensor, r0: int, spec: FeatureSpec, W: int, R: int):
    """(R*W, C*side^2) int32 taps (center-subtracted if RELATIVE) for R rows."""
    D = spec.D
    side = 2 * D + 1
    block = plane[:, r0 : r0 + R + 2 * D, : W + 2 * D]
    taps = torch.stack(
        [block[:, di : di + R, dj : dj + W] for di in range(side) for dj in range(side)],
        dim=1,
    )  # (C, side^2, R, W)
    if spec.relative and D > 0:
        taps = taps - taps[:, (side * side) // 2][:, None]
    return taps.permute(2, 3, 0, 1).reshape(R * W, -1)


def row_block_features(plane, scale, r0: int, spec: FeatureSpec, H: int, W: int,
                       block_rows: int) -> torch.Tensor:
    """Slice path: features for `block_rows` contiguous rows from r0
    (r0 <= H - block_rows).  Returns (block_rows * W, feature_dim) f32.
    Colors-only feature sets (the reference default)."""
    if spec.use_coords or not spec.use_colors:
        raise NotImplementedError(
            "coordinate features are not ported yet (ROADMAP: pipelined "
            "encode/decode and the full-plane decode)"
        )
    taps = _block_taps_int(plane, r0, spec, W, block_rows)
    return taps.to(torch.float32) * scale


def feature_block_rows(H: int, W: int) -> int:
    """Row-block height of the slice path (~128k pixels a block)."""
    return min(H, max(1, (1 << 17) // max(W, 1)))


def build_feature_cache(plane, scale, spec: FeatureSpec, H: int, W: int,
                        padded_in: int, g: int = 1) -> torch.Tensor:
    """Every pixel's final model input row — f32, zero-padded to
    `padded_in` — built once with the slice path: (ceil(H*W/g)*g, padded_in)
    row-major; trailing granule-padding rows are zero.  A training batch is
    then one row gather; for g > 1, ``cache.view(n_g, g*padded_in)`` is the
    granule-grouped view (free in torch)."""
    n = H * W
    rows_total = -(-n // g) * g
    R = feature_block_rows(H, W)
    out = torch.zeros((rows_total, padded_in), dtype=torch.float32, device=plane.device)
    for r0 in range(0, H, R):
        rows = min(R, H - r0)
        feats = row_block_features(plane, scale, r0, spec, H, W, rows)
        out[r0 * W : (r0 + rows) * W, : feats.shape[-1]] = feats
    return out


def build_label_matrix(lsb: torch.Tensor, pad_rows_to: int | None = None) -> torch.Tensor:
    """(C, H, W) integer LSB -> (H*W, C) int32 row-major label matrix, zero
    rows appended up to `pad_rows_to`.  (The JAX package stores labels in
    8-pixel granules to dodge TPU lane padding; the values gathered are the
    same.)"""
    C = lsb.shape[0]
    out = lsb.reshape(C, -1).T.to(torch.int32)
    if pad_rows_to is not None and pad_rows_to > out.shape[0]:
        out = torch.cat([out, out.new_zeros((pad_rows_to - out.shape[0], C))])
    return out.contiguous()


def build_granule_labels(lsb: torch.Tensor, H: int, W: int, g: int) -> torch.Tensor:
    """(C, H, W) integer LSB plane -> (ceil(H*W/g), g*C) int32 matrix of flat
    g-pixel-granule label rows (trailing pixels zero)."""
    C = lsb.shape[0]
    n_g = -(-H * W // g)
    return build_label_matrix(lsb, n_g * g).view(n_g, g * C)

