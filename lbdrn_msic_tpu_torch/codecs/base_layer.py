"""Lossless base-layer codec.

The reference codes the MSB plane with lossless JPEG 2000 via
``gdal_translate -of JP2OpenJPEG -co QUALITY=100 -co REVERSIBLE=YES``
(reference encode.py:137, decode.py:69).  Here:

- ``jp2`` — lossless JPEG 2000 through OpenCV's OpenJPEG binding (same
  underlying codec family as the reference's GDAL JP2 backend).  Bands are packed
  into groups of <= 4 channels per codestream (OpenJPEG-via-cv2 channel
  limit); a tiny container records the grouping.
- ``lpc`` — the framework's native C++ lossless predictive coder
  (codecs/native/lpc.cc): MED/GAP-style prediction + adaptive range coding,
  built for 10/12-bit satellite bands.  Measured on the synthetic suite it
  costs ~2-3 % more bytes than JP2 (e.g. 1.936 vs 1.887 bpsp at WFI
  shapes, +0.1-0.3 % more for v2 chunking) in exchange for much faster,
  chunk-parallel, streamable decode — the throughput/RD trade is
  quantified in docs/PERF.md ("Decode budget").

Both are host-side stages meant to overlap with device training.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

_JP2_MAGIC = b"LJ2C"
_LPC_MAGIC = b"LLPC"


def _band_groups(c: int) -> List[int]:
    """One codestream per band: no ratio cost on multispectral data
    (OpenJPEG codes components independently here) and bands encode/decode
    in parallel threads.  The container records group sizes, so older
    streams with wider groups still decode."""
    return [1] * c


def _encode_jp2(msb: np.ndarray) -> bytes:
    import concurrent.futures

    import cv2

    c, h, w = msb.shape
    groups = _band_groups(c)
    starts = np.cumsum([0] + groups[:-1])

    def enc_one(i_g):
        i, g = i_g
        hwc = np.ascontiguousarray(msb[i : i + g].transpose(1, 2, 0))
        if g == 1:
            hwc = hwc[:, :, 0]
        ok, buf = cv2.imencode(
            ".jp2", hwc, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000]
        )
        if not ok:
            # OpenJPEG rejects tiles < 32px per side at its resolution depth
            raise RuntimeError(
                f"cv2 JPEG2000 encode failed for plane {hwc.shape} "
                "(tiles must be >= 32px per side; use --base-codec lpc for "
                "smaller tiles)"
            )
        return bytes(buf)

    with concurrent.futures.ThreadPoolExecutor(max_workers=min(8, len(groups))) as pool:
        payloads = list(pool.map(enc_one, zip(starts, groups)))
    out = bytearray(_JP2_MAGIC)
    out.append(1)  # version
    out.append(len(groups))
    out.append(1 if msb.dtype == np.uint8 else 2)
    for g, p in zip(groups, payloads):
        out.append(g)
        out += struct.pack("<I", len(p))
    for p in payloads:
        out += p
    return bytes(out)


def _decode_jp2(data: bytes) -> np.ndarray:
    import cv2

    if data[:8] in (b"\x00\x00\x00\x0cjP  ", b"\x00\x00\x00\x0cjP\x1a\x1a") or data[:4] == b"\xff\x4f\xff\x51":
        # a bare JP2 file / J2K codestream: the reference stores the base
        # layer as GDAL-written JP2 bytes (reference encode.py:137) — the
        # v0 BODY is a recorded deviation, see docs/FORMAT.md
        raise ValueError(
            "reference JPEG 2000 base payload detected: reference-produced "
            "v0 bodies are not wire-compatible with this framework "
            "(docs/FORMAT.md, 'v0 body deviation record')"
        )
    if data[:4] != _JP2_MAGIC or data[4] != 1:
        raise ValueError("not an LJ2C stream")
    n_groups = data[5]
    itemsize = data[6]
    ptr = 7
    sizes, groups = [], []
    for _ in range(n_groups):
        groups.append(data[ptr])
        sizes.append(struct.unpack_from("<I", data, ptr + 1)[0])
        ptr += 5
    import concurrent.futures

    chunks = []
    for sz in sizes:
        chunks.append(np.frombuffer(data[ptr : ptr + sz], dtype=np.uint8))
        ptr += sz

    def dec_one(buf):
        img = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise RuntimeError("cv2 JPEG2000 decode failed")
        if img.ndim == 2:
            img = img[:, :, None]
        return img.transpose(2, 0, 1)

    with concurrent.futures.ThreadPoolExecutor(max_workers=min(8, len(chunks))) as pool:
        bands = list(pool.map(dec_one, chunks))
    out = np.concatenate(bands, axis=0)
    want = np.uint8 if itemsize == 1 else np.uint16
    return out.astype(want, copy=False)


LPC_CHUNK_ROWS = 512  # v2 row-chunk size (multiple of the 256-row device block)
LPC_CHUNK_MIN_H = 1536  # below this the v1 single-stream format wins


def encode_base(msb: np.ndarray, codec: str = "jp2") -> bytes:
    """msb: (C, H, W) uint8/uint16 base plane -> lossless codestream.

    Tall LPC planes use the v2 row-chunked wire format (codecs/lpc.py):
    +~0.1-0.3 % bytes for C x n_chunks decode parallelism AND incremental
    chunk decoding, which the streaming decoder overlaps with device
    residual compute + the d2h link (docs/PERF.md "Decode budget")."""
    if msb.ndim != 3:
        raise ValueError(f"expected CHW, got {msb.shape}")
    if codec == "jp2":
        return _encode_jp2(msb)
    if codec == "lpc":
        from lbdrn_msic_tpu_torch.codecs import lpc

        chunk = LPC_CHUNK_ROWS if msb.shape[1] >= LPC_CHUNK_MIN_H else 0
        return lpc.encode(msb, chunk_rows=chunk)
    raise ValueError(f"unknown base codec {codec!r}")


def decode_base(data: bytes, codec: str = "jp2") -> np.ndarray:
    """Inverse of encode_base; returns (C, H, W) with the stored dtype."""
    if codec == "jp2":
        return _decode_jp2(data)
    if codec == "lpc":
        from lbdrn_msic_tpu_torch.codecs import lpc

        return lpc.decode(data)
    raise ValueError(f"unknown base codec {codec!r}")
