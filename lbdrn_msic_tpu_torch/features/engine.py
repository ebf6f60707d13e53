"""Feature/label engine: the four ways training batches are built.

Semantics match the reference pipeline (reference LBDRNdataset.py:92-133 /
decode.py:77-102) and are bit-identical to the JAX package's engine: the
engine works in integer tap space — a feature is
``float32(tap - center) * (1/max)`` — with the plane held as int32 (torch
has few uint16 ops).

Feature vector layout per pixel (the reference's ``sliding_window_view``
order, LBDRNdataset.py:119-129): ``[band0: (2D+1)^2 taps row-major, band1:
..., ...]`` with taps optionally center-subtracted (RELATIVE) and
max-normalized.  Coordinate features are not ported yet.

Training batches come from one of four staging modes, largest first:
"cached", every pixel's final f32 model input row (`build_feature_cache`),
where a batch is one row gather; "full", every pixel's integer taps in
their smallest dtype (`build_tap_matrix`), where a batch is one row
gather, a convert and a scale (`staged_features`); "banded", every padded
row's horizontal windows in g-pixel granules (`build_row_taps`, ~1/5 of
"full"), where a batch is `side` row gathers a granule
(`banded_window_features`); and "gather", nothing staged, a batch
gathered tap by tap from the padded plane (`gather_features`).  Every mode
gives values bit-identical to the slice path (`row_block_features`).
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


def _write_features(taps: torch.Tensor, scale: torch.Tensor, g: int,
                    out: torch.Tensor | None) -> torch.Tensor:
    """(m, g, C, side, side) integer taps -> (m * g, F) f32 times `scale`,
    or written into `out`: an f32 view of m * g rows of F values (say the
    first F columns of a zero-padded batch buffer, with any leading axes)."""
    m = taps.shape[0]
    if out is None:
        return taps.reshape(m * g, -1).to(torch.float32) * scale
    o = out.unflatten(-2, (-1, g)).unflatten(-1, taps.shape[2:])
    o.copy_(taps.view(o.shape))
    return out.mul_(scale)


def gather_features(plane, scale, pixel_idx: torch.Tensor, spec: FeatureSpec, H: int,
                    W: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Gather path ("gather" staging: nothing staged): features of flat
    pixel ids (clipped to the image), each window's taps gathered from the
    padded plane (C, H+2D, W+2D).  Returns (B, feature_dim) f32, or writes
    into `out` as `_write_features` does."""
    if spec.use_coords or not spec.use_colors:
        raise NotImplementedError(
            "coordinate features are not ported yet (ROADMAP: pipelined "
            "encode/decode and the full-plane decode)"
        )
    C = plane.shape[0]
    D = spec.D
    side = 2 * D + 1
    Wp = W + 2 * D
    idx = torch.clamp(pixel_idx, 0, H * W - 1)
    base = idx // W * Wp + idx % W  # the window's top-left corner, padded coords
    offs = (torch.arange(side, device=idx.device)[:, None] * Wp
            + torch.arange(side, device=idx.device)).view(-1)
    win = (base[:, None] + offs).view(-1)
    taps = plane.reshape(C, -1)[:, win].view(C, -1, side, side).permute(1, 0, 2, 3)
    if spec.relative and D > 0:
        taps = taps - taps[:, :, D : D + 1, D : D + 1]
    return _write_features(taps[:, None], scale, 1, out)


def row_taps_dtype(max_value: int) -> torch.dtype:
    """Smallest dtype for RAW (not center-subtracted) plane values: uint8,
    else int16 where the JAX package uses uint16 (torch's uint16 has few
    operators; raw values above 32767 take int32).  `codec._tap_itemsize`
    keeps the JAX package's byte count."""
    if max_value <= 255:
        return torch.uint8
    return torch.int16 if max_value <= 32767 else torch.int32


def banded_geometry(W: int, g: int) -> Tuple[int, int]:
    """(Wg, ng_row): width padded to a granule multiple, granules per row."""
    ng_row = -(-W // g)
    return ng_row * g, ng_row


def build_row_taps(plane, spec: FeatureSpec, H: int, W: int, g: int,
                   dtype: torch.dtype = torch.int16) -> torch.Tensor:
    """Banded staging: every padded row's horizontal windows, raw (not
    center-subtracted): (Hp * ng_row, g * C * side) `dtype`, Hp = H + 2D,
    ng_row = ceil(W / g).  Row ``r * ng_row + jg`` holds, in (g, C, side)
    order, ``plane[c, r, jg*g + t + dj]`` for pixel t < g of the granule and
    window column dj < side; columns past W are zero.  A pixel's window is
    put back together at batch time from `side` of these rows
    (`banded_window_features`), for ~1/5 of the full tap matrix's bytes.
    One strided copy of the plane's column windows (`unfold`)."""
    C = plane.shape[0]
    side = 2 * spec.D + 1
    Hp = H + 2 * spec.D
    Wg, ng_row = banded_geometry(W, g)
    out = torch.zeros((Hp, Wg, C, side), dtype=dtype, device=plane.device)
    out[:, :W] = plane[:, :Hp, : W + 2 * spec.D].unfold(2, side, 1).permute(1, 2, 0, 3)
    return out.view(Hp * ng_row, g * C * side)


def banded_window_features(row_taps: torch.Tensor, scale, gidx: torch.Tensor,
                           spec: FeatureSpec, H: int, W: int, g: int,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Banded path: features of granule ids over the W-padded grid, gidx in
    [0, H * ng_row).  Returns (m * g, feature_dim) f32, or writes into
    `out` as `_write_features` does; padding columns (j >= W) give zero-tap
    rows, which callers mask."""
    if spec.use_coords or not spec.use_colors:
        raise NotImplementedError(
            "coordinate features are not ported yet (ROADMAP: pipelined "
            "encode/decode and the full-plane decode)"
        )
    D = spec.D
    side = 2 * D + 1
    _, ng_row = banded_geometry(W, g)
    C = row_taps.shape[-1] // (g * side)
    m = gidx.shape[0]
    # granule (i, jg)'s window rows: padded rows i + di, granule column jg
    rows = gidx[:, None] + torch.arange(side, device=gidx.device) * ng_row
    taps = torch.index_select(row_taps, 0, rows.view(-1)).view(m, side, g, C, side)
    taps = taps.permute(0, 2, 3, 1, 4)  # (m, g, C, di, dj)
    if spec.relative and D > 0:
        taps = taps.to(torch.int32)
        taps = taps - taps[:, :, :, D : D + 1, D : D + 1]
    return _write_features(taps, scale, g, out)


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


def tap_matrix_dtype(max_value: int, relative: bool) -> torch.dtype:
    """Smallest integer dtype that holds every tap value: relative taps span
    [-max, max], absolute ones [0, max].  Absolute taps above 255 are held
    as int32, where the JAX package uses uint16 (torch's uint16 has few
    operators); `codec._tap_itemsize` keeps the JAX package's byte count."""
    if relative:
        if max_value <= 127:
            return torch.int8
        return torch.int16 if max_value <= 32767 else torch.int32
    return torch.uint8 if max_value <= 255 else torch.int32


def build_tap_matrix(plane, spec: FeatureSpec, H: int, W: int,
                     dtype: torch.dtype = torch.int16, g: int = 1) -> torch.Tensor:
    """Every pixel's integer taps (center-subtracted if RELATIVE), in flat
    g-pixel granules: (ceil(H*W/g), g * C*(2D+1)^2) `dtype`; trailing pixels
    of the last granule are zero.  Built in row blocks with the slice path
    into the (rows, taps) matrix, whose granule view is free."""
    if spec.use_coords or not spec.use_colors:
        raise NotImplementedError(
            "coordinate features are not ported yet (ROADMAP: pipelined "
            "encode/decode and the full-plane decode)"
        )
    C = plane.shape[0]
    F = C * (2 * spec.D + 1) ** 2
    n_g = -(-H * W // g)
    out = torch.zeros((n_g * g, F), dtype=dtype, device=plane.device)
    R = feature_block_rows(H, W)
    for r0 in range(0, H, R):
        rows = min(R, H - r0)
        out[r0 * W : (r0 + rows) * W] = _block_taps_int(plane, r0, spec, W, rows).to(dtype)
    return out.view(n_g, g * F)


def staged_features(taps: torch.Tensor, scale: torch.Tensor, idx: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """Staged path: rows `idx` of a tap matrix as f32 times `scale`, the
    values of `row_block_features` for those pixels (or granules).  `out`:
    an f32 view of the same number of elements (say the first F columns of
    a zero-padded batch buffer) that the rows are written into."""
    rows = torch.index_select(taps, 0, idx)
    if out is None:
        return rows.to(torch.float32) * scale
    out.copy_(rows.view(out.shape))
    return out.mul_(scale)


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


def build_banded_labels(lsb: torch.Tensor, H: int, W: int, g: int) -> torch.Tensor:
    """(C, H, W) integer LSB plane -> (H * ng_row, g * C) int32 matrix of
    granule-row labels over the W-padded grid, zero in the padding
    columns (the training loop masks them)."""
    C = lsb.shape[0]
    Wg, ng_row = banded_geometry(W, g)
    out = torch.zeros((H, Wg, C), dtype=torch.int32, device=lsb.device)
    out[:, :W] = lsb.permute(1, 2, 0)
    return out.view(H * ng_row, g * C)


def gather_pixel_labels(labels: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Label rows of pixel ids `idx` (in range) from an (n, C) label
    matrix.  (The JAX package gathers 8-pixel granule rows and selects the
    member, to dodge TPU lane padding; the values are the same.)"""
    return torch.index_select(labels, 0, idx)


def gather_labels(label_matrix: torch.Tensor, scale, pixel_idx: torch.Tensor) -> torch.Tensor:
    """(B, C) f32 label vectors of flat pixel ids (clipped), times `scale`
    (1/(2^K - 1))."""
    idx = torch.clamp(pixel_idx, 0, label_matrix.shape[0] - 1)
    return gather_pixel_labels(label_matrix, idx).to(torch.float32) * scale


def build_granule_labels(lsb: torch.Tensor, H: int, W: int, g: int) -> torch.Tensor:
    """(C, H, W) integer LSB plane -> (ceil(H*W/g), g*C) int32 matrix of flat
    g-pixel-granule label rows (trailing pixels zero)."""
    C = lsb.shape[0]
    n_g = -(-H * W // g)
    return build_label_matrix(lsb, n_g * g).view(n_g, g * C)

