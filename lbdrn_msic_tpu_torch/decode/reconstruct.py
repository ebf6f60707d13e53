"""Device-side reconstruction: replay the network over the decoded base layer.

Mirrors the reference decoder's math (reference decode.py:77-139): rebuild
the exact feature tensor from the decoded base plane, run the MLP with
exact `sin`, then ``residual = round(pred * (2^K - 1))`` and
``image = (base << K) + residual`` in uint16.  The device computes the
residual of each row band and returns it as K bitplanes; the host, which
already holds the base, adds it back (`_assemble_band`).  Colour-only
streams upload the base band by band with its D-row halo
(`_residual_band_planes_local`); streams with coordinate features, which
need each pixel's global row, upload the whole base once
(`_residual_band_planes`).  Row-chunked `lpc` base streams decode chunk
by chunk on the host while the device computes the bands already decoded
(`dispatch_streamed_lpc`).  `reconstruct` is the whole tile in one call,
the reference's form of the same math.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os

import numpy as np
import torch

from lbdrn_msic_tpu_torch.codecs import _native
from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec
from lbdrn_msic_tpu_torch.features.engine import pad_plane, reflect_index, row_block_features
from lbdrn_msic_tpu_torch.models.siren import SirenParams, forward, pad_dim, pad_features
from lbdrn_msic_tpu_torch.utils.transfer import put_image

N_PLANES = 16  # residual bitplane slots (covers any K; planes >= K are zero)


def reconstruct(base: torch.Tensor, params: SirenParams, fspec: FeatureSpec,
                mspec: ModelSpec, K: int, H: int, W: int,
                block_rows: int = 256) -> torch.Tensor:
    """base: (C, H, W) integer tensor of the decoded base layer -> the
    (C, H, W) image as int32 values in [0, 2^16): row blocks of the padded
    plane through the network (exact `sin`), ``image = (base << K) +
    round(pred * (2^K - 1))``, on the base's device."""
    C = base.shape[0]
    plane, scale = pad_plane(base, fspec.D)
    padded_in = pad_dim(fspec.feature_dim(C))
    R = min(block_rows, H)
    lsb_peak = float(np.float32((1 << K) - 1))
    out = base.to(torch.int32) << K
    with torch.no_grad():
        for b in range(-(-H // R)):
            r0 = min(b * R, H - R)
            x = row_block_features(plane, scale, r0, fspec, H, W, R)
            pred = forward(params, pad_features(x, padded_in), mspec)
            residual = torch.round(pred * lsb_peak).to(torch.int32)
            skip = b * R - r0  # rows the clamped last block shares with its predecessor
            out[:, r0 + skip : r0 + R] += residual.reshape(R, W, C).permute(2, 0, 1)[:, skip:]
    return out


def reconstruct_np(base: np.ndarray, params: SirenParams, fspec: FeatureSpec,
                   mspec: ModelSpec, K: int, device: torch.device) -> np.ndarray:
    """`reconstruct` of a host base layer on `device` -> (C, H, W) uint16."""
    _, H, W = base.shape
    out = reconstruct(put_image(base, device), params, fspec, mspec, K, H, W)
    return out.cpu().numpy().astype(np.uint16)


def _residual_band_planes(plane: torch.Tensor, scale: torch.Tensor, params: SirenParams,
                          r0: int, fspec: FeatureSpec, mspec: ModelSpec, K: int, H: int,
                          W: int, band_rows: int) -> torch.Tensor:
    """Residual bitplanes of the row band [r0, r0 + band_rows) from the
    whole padded base plane (`pad_plane` of the full tile: (C, H+2D, W+2D)
    int32, `scale` its 1/max), so each block's features read global row
    indices, as coordinate features need.  Returns the K live bitplanes,
    (K, ceil(n/8)) uint8 in np.unpackbits order."""
    C = plane.shape[0]
    padded_in = pad_dim(fspec.feature_dim(C))
    R = min(256, band_rows)
    lsb_peak = float(np.float32((1 << K) - 1))
    out = torch.empty((C, band_rows, W), dtype=torch.int32, device=plane.device)
    for b in range(-(-band_rows // R)):
        rb = min(r0 + b * R, H - R)
        x = row_block_features(plane, scale, rb, fspec, H, W, R)
        pred = forward(params, pad_features(x, padded_in), mspec)
        residual = torch.round(pred * lsb_peak).to(torch.int32)
        out[:, rb - r0 : rb - r0 + R] = residual.reshape(R, W, C).permute(2, 0, 1)
    return _pack_bitplanes(out, K)


def _residual_band_planes_local(band: torch.Tensor, params: SirenParams,
                                scale: torch.Tensor, fspec: FeatureSpec,
                                mspec: ModelSpec, K: int, W: int,
                                band_rows: int) -> torch.Tensor:
    """Residual bitplanes for ONE uploaded row band.

    `band`: (C, band_rows + 2D, W) raw rows — the band plus its D-row halo
    (true neighbour rows inside the image, host-reflected rows at its
    edges), so features are bit-identical to the full-plane computation.
    `scale`: the GLOBAL 1/max of the base plane (0-d f32).  Colors-only
    feature sets.  Returns the K live bitplanes, (K, ceil(n/8)) uint8 in
    np.unpackbits order.
    """
    C = band.shape[0]
    D = fspec.D
    plane = band.to(torch.int32)
    if D > 0:
        plane = plane[:, :, reflect_index(W, D, plane.device)]
    padded_in = pad_dim(fspec.feature_dim(C))
    R = min(256, band_rows)
    lsb_peak = float(np.float32((1 << K) - 1))
    out = torch.empty((C, band_rows, W), dtype=torch.int32, device=band.device)
    for b in range(-(-band_rows // R)):
        rb = min(b * R, band_rows - R)
        x = row_block_features(plane, scale, rb, fspec, band_rows, W, R)
        pred = forward(params, pad_features(x, padded_in), mspec)
        residual = torch.round(pred * lsb_peak).to(torch.int32)
        out[:, rb : rb + R] = residual.reshape(R, W, C).permute(2, 0, 1)
    return _pack_bitplanes(out, K)


def _pack_bitplanes(out: torch.Tensor, n_planes: int = N_PLANES) -> torch.Tensor:
    """(...) integer residuals -> (n_planes, ceil(n/8)) uint8 bitplanes
    (np.unpackbits 'big' bit order)."""
    flat = out.reshape(-1).to(torch.int32)
    n = flat.shape[0]
    nb = -(-n // 8)
    if nb * 8 != n:
        flat = torch.cat([flat, flat.new_zeros(nb * 8 - n)])
    octets = flat.view(nb, 8)
    weights = torch.tensor([1 << s for s in range(7, -1, -1)], dtype=torch.int32,
                           device=out.device)
    planes = [(((octets >> j) & 1) * weights).sum(-1).to(torch.uint8)
              for j in range(n_planes)]
    return torch.stack(planes)


def _band_halo(base: np.ndarray, r0: int, band_rows: int, D: int) -> np.ndarray:
    """Host-side band slice with a D-row halo; edge halos reflect the image
    rows like numpy's mode='reflect' pad."""
    H = base.shape[1]
    idx = np.arange(r0 - D, r0 + band_rows + D)
    idx = np.where(idx < 0, -idx, idx)
    idx = np.where(idx >= H, 2 * (H - 1) - idx, idx)
    return np.ascontiguousarray(base[:, idx, :])


def _band_layout(H: int, n_bands: int) -> tuple[int, int]:
    """(n_bands, band_rows): uniform bands, multiple of the 256-row block so
    in-band blocks never spill past a band boundary."""
    if H < 512:
        return 1, H
    band_rows = -(-(-(-H // n_bands)) // 256) * 256
    return -(-H // band_rows), band_rows


def dispatch_streamed(base: np.ndarray, params: SirenParams, fspec: FeatureSpec,
                      mspec: ModelSpec, K: int, device: torch.device, n_bands: int = 8):
    """Queue the residual computation of every row band of one tile on the
    device (asynchronous on CUDA) and return a zero-arg closure that fetches
    the bands and assembles the final uint16 image on the host.  Colour-only
    feature sets upload each band with its host-built halo (`_band_halo`);
    coordinate features need global row indices, so their base goes up
    whole, once, and every band reads it (`_residual_band_planes`)."""
    C, H, W = base.shape
    n_bands, band_rows = _band_layout(H, n_bands)
    pend = []
    if fspec.use_coords:
        plane, scale = pad_plane(put_image(base, device), fspec.D)
        for b in range(n_bands):
            r0 = min(b * band_rows, H - band_rows)
            pend.append((r0, _residual_band_planes(plane, scale, params, r0, fspec, mspec,
                                                   K, H, W, band_rows)))
        return _make_finish(base, pend, band_rows, K)
    scale = torch.tensor(np.float32(1.0) / np.float32(max(int(base.max()), 1)),
                         device=device)
    for b in range(n_bands):
        r0 = min(b * band_rows, H - band_rows)
        band = put_image(_band_halo(base, r0, band_rows, fspec.D), device)
        planes = _residual_band_planes_local(band, params, scale, fspec, mspec,
                                             K, W, band_rows)
        pend.append((r0, planes))
    return _make_finish(base, pend, band_rows, K)


def _assemble_band(got, base_blk: np.ndarray, K: int) -> np.ndarray:
    """K residual bitplanes + contiguous base block -> uint16 image block.

    Native single-pass routine when available (codecs/native/assemble.cc);
    the numpy unpackbits path is its oracle."""
    n = base_blk.size
    lib = _native.load()
    if lib is not None and K <= 16:
        out = np.empty(base_blk.shape, np.uint16)
        arrs = [np.ascontiguousarray(p) for p in got]
        ptrs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
        rc = lib.lbdrn_assemble_residual(
            ptrs, K,
            ctypes.c_void_p(base_blk.ctypes.data),
            1 if base_blk.dtype == np.uint8 else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            n,
        )
        if rc == 0:
            return out
    return _assemble_band_np(got, base_blk, K)


def _assemble_band_np(got, base_blk: np.ndarray, K: int) -> np.ndarray:
    n = base_blk.size
    res = np.zeros(n, np.uint16)
    for j, plane_bytes in enumerate(got):
        res |= np.unpackbits(plane_bytes)[:n].astype(np.uint16) << j
    return (base_blk.astype(np.uint16) << K) + res.reshape(base_blk.shape)


def _make_finish(base: np.ndarray, pend, band_rows: int, K: int):
    """Zero-arg closure fetching the dispatched residual bands and
    assembling the final uint16 image on the host."""
    C, H, W = base.shape

    def finish() -> np.ndarray:
        out = np.empty((C, H, W), np.uint16)

        def assemble(item):
            # when H % band_rows != 0 the final band (r0 = H - band_rows)
            # overlaps its predecessor's rows; skip them so two pool
            # threads never write the same rows
            b, (r0, dev_planes) = item
            skip = max(0, b * band_rows - r0)
            got = list(dev_planes.cpu().numpy())
            blk = np.ascontiguousarray(base[:, r0 : r0 + band_rows])
            out[:, r0 + skip : r0 + band_rows] = _assemble_band(got, blk, K)[:, skip:]

        with concurrent.futures.ThreadPoolExecutor(max_workers=3) as pool:
            list(pool.map(assemble, enumerate(pend)))
        return out

    return finish


def dispatch_streamed_lpc(stream: bytes, params: SirenParams, fspec: FeatureSpec,
                          mspec: ModelSpec, K: int, device: torch.device):
    """Decode straight from a row-chunked (v2) `lpc` base stream: the host
    decodes its chunks in a thread pool while device band k is queued as
    soon as chunks k and k + 1 (its D-row bottom halo) are decoded, and two
    threads fetch and assemble each band once it is queued.  The v2 header
    carries the plane's max, so the feature scale is known before any
    chunk is decoded: ``float32(1) / float32(max(mx, 1))``, the float32
    that `dispatch_streamed` computes from the whole base.  Colour-only
    feature sets; returns (base, finish) with `finish()` the assembled
    uint16 image, bit-identical to `dispatch_streamed`'s, or None when the
    stream is not v2-chunked or its chunks are shorter than D (the caller
    takes the plain path)."""
    from lbdrn_msic_tpu_torch.codecs import lpc

    info = lpc.chunk_info(stream)
    if info is None:
        return None
    C, H, W, itemsize, cr, nk, mx = info
    # cr < D would put part of band k's bottom halo in chunk k + 2, which
    # the dispatch does not wait for
    if nk < 2 or H < cr or cr < fspec.D or fspec.use_coords:
        return None
    dtype = np.uint8 if itemsize == 1 else np.uint16
    base = np.empty((C, H, W), dtype)
    scale = torch.tensor(np.float32(1.0) / np.float32(max(mx, 1)), device=device)

    def dec_one(ci, k):
        r0 = k * cr
        rows = min(cr, H - r0)
        base[ci, r0 : r0 + rows] = lpc.decode_chunk(stream, ci, k, rows, W).astype(dtype)

    out = np.empty((C, H, W), np.uint16)

    def assemble(r0, skip, dev_planes):
        # `skip`: rows the final band (r0 = H - cr) shares with the band
        # before it, so two threads never write the same rows
        got = list(dev_planes.cpu().numpy())
        blk = np.ascontiguousarray(base[:, r0 : r0 + cr])
        out[:, r0 + skip : r0 + cr] = _assemble_band(got, blk, K)[:, skip:]

    # ctypes releases the GIL: the chunk decodes run on every host core
    with concurrent.futures.ThreadPoolExecutor(max(2, os.cpu_count() or 2)) as dec_pool:
        futs = [[dec_pool.submit(dec_one, ci, k) for ci in range(C)] for k in range(nk)]
        asm_pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)
        asm_futs = []
        for k in range(nk):
            for f in futs[k] + (futs[k + 1] if k + 1 < nk else []):
                f.result()
            r0 = min(k * cr, H - cr)  # uniform bands
            band = put_image(_band_halo(base, r0, cr, fspec.D), device)
            planes = _residual_band_planes_local(band, params, scale, fspec, mspec, K, W, cr)
            asm_futs.append(asm_pool.submit(assemble, r0, max(0, k * cr - r0), planes))

    def finish() -> np.ndarray:
        try:
            for f in asm_futs:
                f.result()
        finally:
            asm_pool.shutdown()
        return out

    return base, finish


def reconstruct_streamed(base: np.ndarray, params: SirenParams, fspec: FeatureSpec,
                         mspec: ModelSpec, K: int, device: torch.device,
                         n_bands: int = 8) -> np.ndarray:
    """`dispatch_streamed` and its finish in one call: the bands' residuals
    queued on the device, then fetched and assembled (K bits a subpixel
    cross from the device)."""
    with torch.no_grad():
        return dispatch_streamed(base, params, fspec, mspec, K, device, n_bands)()
