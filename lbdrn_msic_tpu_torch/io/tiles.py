"""Spatial tiling: split an image into sr x sr independent tiles and merge back.

Remainder semantics match the reference exactly (reference
LBDRNdataset.py:46-68 split, :12-43 merge): nominal tile size is
``(H // sr, W // sr)`` and the last row/column of tiles absorbs the
remainder.  Tiles are fully independent — reflect padding and max
normalization during feature building are tile-local — which makes the tile
grid the natural unit of cross-chip fan-out (SURVEY §2.3).
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np


def tile_bounds(height: int, width: int, split_ratio: int) -> List[Tuple[int, int, int, int]]:
    """Row-major list of (y0, x0, th, tw) for each tile."""
    th, tw = height // split_ratio, width // split_ratio
    bounds = []
    for i in range(split_ratio):
        for j in range(split_ratio):
            y0, x0 = i * th, j * tw
            h = th if i + 1 < split_ratio else height - y0
            w = tw if j + 1 < split_ratio else width - x0
            bounds.append((y0, x0, h, w))
    return bounds


def split_image(img: np.ndarray, split_ratio: int) -> Iterator[np.ndarray]:
    """Yield CHW tiles in row-major order."""
    _, H, W = img.shape
    for y0, x0, h, w in tile_bounds(H, W, split_ratio):
        yield np.ascontiguousarray(img[:, y0 : y0 + h, x0 : x0 + w])


def merge_tiles(
    tiles: List[np.ndarray], height: int, width: int, split_ratio: int
) -> np.ndarray:
    """Reassemble row-major CHW tiles into a (C, height, width) array."""
    c = tiles[0].shape[0]
    out = np.zeros((c, height, width), dtype=tiles[0].dtype)
    for tile, (y0, x0, h, w) in zip(tiles, tile_bounds(height, width, split_ratio)):
        if tile.shape[1:] != (h, w):
            raise ValueError(f"tile shape {tile.shape[1:]} != expected {(h, w)}")
        out[:, y0 : y0 + h, x0 : x0 + w] = tile
    return out
