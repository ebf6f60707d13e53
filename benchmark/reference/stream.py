"""The codec's stream, read without the program: the v1 header and the
LFPZ weight payload.

Written from the format's description (docs/FORMAT.md; the port's
io/header.py, codecs/weights.py and codecs/rangecoder.py at commit
4cadcd2): a v1 stream is ``header | per tile: weights payload | base
payload``.  The base payload is not read here: the judge holds the
decoded MSBs against the scene the benchmark made.
"""

from __future__ import annotations

import struct

import numpy as np

V1_MAGIC = 0xFF
BASE_CODECS = {0: "jp2", 1: "lpc"}
WEIGHT_CODECS = {0: "fpz", 1: "raw16"}


def parse_header(data: bytes) -> dict:
    """The v1 header's fields; raises on anything else."""
    if len(data) < 17 or data[0] != V1_MAGIC or data[1] != 1:
        raise ValueError("not a v1 stream")
    (n,) = struct.unpack_from(">H", data, 2)
    sr = data[4]
    width, height = struct.unpack_from(">II", data, 5)
    flags = data[15]
    h = {
        "split_ratio": sr, "width": width, "height": height,
        "K": data[13] >> 4, "D": data[13] & 0xF,
        "base_channel": 1 << (data[14] >> 4), "num_layers": data[14] & 0xF,
        "use_coords": bool(flags & 1), "embedding": bool(flags & 2),
        "use_colors": bool(flags & 4), "relative": bool(flags & 8),
        "weight_codec": WEIGHT_CODECS.get((flags >> 4) & 0x3, "?"),
        "base_codec": BASE_CODECS.get((flags >> 6) & 0x3, "?"),
        "precision": data[16],
    }
    ptr = 17
    h["nn_bytes"] = [int.from_bytes(data[ptr + 3 * t: ptr + 3 * t + 3], "big")
                     for t in range(sr * sr)]
    ptr += 3 * sr * sr
    h["base_bytes"] = [int.from_bytes(data[ptr + 4 * t: ptr + 4 * t + 4], "big")
                       for t in range(sr * sr)]
    ptr += 4 * sr * sr
    if ptr != n:
        raise ValueError(f"v1 header length {n} != parsed {ptr}")
    h["header_bytes"] = n
    return h


def tile_weights(data: bytes, h: dict) -> list:
    """Each tile's weights payload."""
    ptr, out = h["header_bytes"], []
    for nn, base in zip(h["nn_bytes"], h["base_bytes"]):
        out.append(data[ptr: ptr + nn])
        ptr += nn + base
    if ptr != len(data):
        raise ValueError(f"stream holds {len(data)} bytes, its header {ptr}")
    return out


# adaptive binary range decoder: 11-bit probabilities, init 1024,
# adaptation shift 5, LZMA-style renormalisation below 2^24
_PROB_BITS, _PROB_MAX, _SHIFT, _TOP, _M32 = 11, 1 << 11, 5, 1 << 24, 0xFFFFFFFF


def _decode_trees(payload: bytes, count: int, chunks: list) -> np.ndarray:
    """`count` codes, each its chunks MSB first, every chunk a bit tree;
    the top chunk's tree is chosen by the previous value's top chunk."""
    data = payload + b"\x00" * 16
    pos, rng, code = 5, _M32, int.from_bytes(data[1:5], "big")
    first = chunks[0]
    top_probs = [[1 << (_PROB_BITS - 1)] * (1 << first) for _ in range(1 << first)]
    low_probs = [[1 << (_PROB_BITS - 1)] * 256 for _ in chunks[1:]]
    out = np.empty(count, dtype=np.uint32)
    prev = 0
    for i in range(count):
        q = 0
        for ci, nbits in enumerate(chunks):
            probs = top_probs[prev] if ci == 0 else low_probs[ci - 1]
            ctx = 1
            for _ in range(nbits):
                p = probs[ctx]
                bound = (rng >> _PROB_BITS) * p
                if code < bound:
                    rng = bound
                    probs[ctx] = p + ((_PROB_MAX - p) >> _SHIFT)
                    ctx <<= 1
                else:
                    code -= bound
                    rng -= bound
                    probs[ctx] = p - (p >> _SHIFT)
                    ctx = (ctx << 1) | 1
                while rng < _TOP:
                    rng = (rng << 8) & _M32
                    code = ((code << 8) | data[pos]) & _M32
                    pos += 1
            value = ctx - (1 << nbits)
            if ci == 0:
                prev = value
            q = (q << nbits) | value
        out[i] = q
    return out


def lfpz_decode(payload: bytes) -> np.ndarray:
    """An LFPZ payload -> float32 values.  Wire: b"LFPZ" | u8 version 1 |
    u8 precision | u32le count | range-coded codes.  A code is the top
    `precision` bits of the float's order-preserving map (negative: ~bits,
    positive: bits | 2^31), split MSB first into chunks of at most 8 bits,
    the first taking the remainder."""
    if payload[:4] != b"LFPZ":
        raise ValueError("not an LFPZ payload")
    version, precision, count = struct.unpack_from("<BBI", payload, 4)
    if version != 1 or not 4 <= precision <= 32:
        raise ValueError(f"LFPZ version {version}, precision {precision}")
    n = -(-precision // 8)
    chunks = [precision - 8 * (n - 1)] + [8] * (n - 1)
    codes = _decode_trees(payload[10:], count, chunks).astype(np.uint64)
    codes = (codes << np.uint64(32 - precision)).astype(np.uint32)
    pos = (codes & np.uint32(0x80000000)) != 0
    bits = np.where(pos, codes & np.uint32(0x7FFFFFFF), ~codes).astype(np.uint32)
    return bits.view(np.float32)
