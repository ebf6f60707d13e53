"""Weight codec: precision-limited float32 compression ("fpz" / LFPZ format).

Plays the role fpzip plays in the reference (reference encode.py:129 /
decode.py:113): the flattened network weights, truncated to ``precision``
retained bits, entropy-coded — the result IS the enhancement-layer
bitstream.  fpzip itself is absent from this runtime, so the framework ships
its own format:

- float32 bits are mapped to a monotonic unsigned code
  (sign-flip: negative -> ~bits, positive -> bits | 0x80000000),
- the top ``precision`` bits are kept (fpzip-style magnitude truncation),
- each value's code is split into MSB-first byte-ish chunks, each coded by
  an adaptive bit-tree over the range coder; the top chunk (sign+exponent)
  is additionally conditioned on the previous value's top chunk, which the
  layered structure of the weight vector rewards.

The native C++ implementation (codecs/native/fpzcodec.cc) produces
byte-identical streams; this module transparently uses it when built.

Wire: b"LFPZ" | u8 version=1 | u8 precision | u32le count | payload.
"""

from __future__ import annotations

import struct

import numpy as np

from lbdrn_msic_tpu_torch.codecs import _native
from lbdrn_msic_tpu_torch.codecs.rangecoder import (
    RangeDecoder,
    RangeEncoder,
    new_probs,
)

MAGIC = b"LFPZ"
VERSION = 1


def _to_code(values: np.ndarray) -> np.ndarray:
    bits = values.astype(np.float32).view(np.uint32)
    neg = (bits & 0x80000000) != 0
    return np.where(neg, ~bits, bits | 0x80000000).astype(np.uint32)


def _from_code(codes: np.ndarray) -> np.ndarray:
    pos = (codes & 0x80000000) != 0
    bits = np.where(pos, codes & 0x7FFFFFFF, ~codes).astype(np.uint32)
    return bits.view(np.float32)


def _chunk_bits(precision: int):
    """Split a `precision`-bit code MSB-first into chunks of <= 8 bits.

    First chunk carries `precision - 8*(n-1)` bits (sign + exponent region).
    """
    n = -(-precision // 8)
    first = precision - 8 * (n - 1)
    return [first] + [8] * (n - 1)


def quantize(values: np.ndarray, precision: int) -> np.ndarray:
    """The precision truncation alone (what the decoder will see)."""
    if not (4 <= precision <= 32):
        raise ValueError(f"precision must be in 4..32, got {precision}")
    codes = _to_code(values)
    if precision < 32:
        codes = (codes >> (32 - precision)) << (32 - precision)
    return _from_code(codes)


def compress(values: np.ndarray, precision: int = 16) -> bytes:
    if not (4 <= precision <= 32):
        raise ValueError(f"precision must be in 4..32, got {precision}")
    flat = np.ascontiguousarray(values, dtype=np.float32).reshape(-1)
    native = _native.load()
    if native is not None:
        import ctypes

        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_uint64()
        rc = native.lfpz_compress(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            flat.size, precision, ctypes.byref(out), ctypes.byref(out_len),
        )
        if rc == 0:
            try:
                return ctypes.string_at(out, out_len.value)
            finally:
                native.lbdrn_free(out)
    return _compress_py(flat, precision)


def _compress_py(flat: np.ndarray, precision: int) -> bytes:
    codes = _to_code(flat)
    if precision < 32:
        codes >>= 32 - precision
    chunks = _chunk_bits(precision)
    first_bits = chunks[0]

    enc = RangeEncoder()
    # top chunk: bit-tree conditioned on previous value's top chunk
    top_ctx_probs = [new_probs(1 << first_bits) for _ in range(1 << first_bits)]
    low_probs = [new_probs(256) for _ in range(len(chunks) - 1)]
    prev_top = 0
    codes_list = codes.tolist()
    shifts = []
    acc = 0
    for b in reversed(chunks):
        shifts.append(acc)
        acc += b
    shifts = list(reversed(shifts))  # shift for each chunk, MSB-first
    for q in codes_list:
        top = (q >> shifts[0]) & ((1 << first_bits) - 1)
        enc.encode_tree(top_ctx_probs[prev_top], first_bits, top)
        prev_top = top
        for ci in range(1, len(chunks)):
            byte = (q >> shifts[ci]) & 0xFF
            enc.encode_tree(low_probs[ci - 1], 8, byte)
    payload = enc.finish()
    header = MAGIC + struct.pack("<BBI", VERSION, precision, flat.size)
    return header + payload


def decompress(data: bytes) -> np.ndarray:
    if data[:3] in (b"fpz", b"fpy"):
        # reference weight payload (LLNL fpzip, reference encode.py:129):
        # the v0 BODY is a recorded deviation — see docs/FORMAT.md
        raise ValueError(
            "reference fpzip weight payload detected: reference-produced v0 "
            "bodies are not wire-compatible with this framework "
            "(docs/FORMAT.md, 'v0 body deviation record')"
        )
    if data[:4] != MAGIC:
        raise ValueError("not an LFPZ stream")
    version, precision, count = struct.unpack_from("<BBI", data, 4)
    if version != VERSION:
        raise ValueError(f"unsupported LFPZ version {version}")
    native = _native.load()
    if native is not None:
        import ctypes

        buf = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(count, np.float32)
        rc = native.lfpz_decompress(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.size,
        )
        if rc == 0:
            return out
    return _decompress_py(data)


def _decompress_py(data: bytes) -> np.ndarray:
    version, precision, count = struct.unpack_from("<BBI", data, 4)
    chunks = _chunk_bits(precision)
    first_bits = chunks[0]
    shifts = []
    acc = 0
    for b in reversed(chunks):
        shifts.append(acc)
        acc += b
    shifts = list(reversed(shifts))

    dec = RangeDecoder(data[10:])
    top_ctx_probs = [new_probs(1 << first_bits) for _ in range(1 << first_bits)]
    low_probs = [new_probs(256) for _ in range(len(chunks) - 1)]
    prev_top = 0
    out = np.empty(count, dtype=np.uint32)
    for i in range(count):
        top = dec.decode_tree(top_ctx_probs[prev_top], first_bits)
        prev_top = top
        q = top << shifts[0]
        for ci in range(1, len(chunks)):
            q |= dec.decode_tree(low_probs[ci - 1], 8) << shifts[ci]
        out[i] = q
    if precision < 32:
        out <<= 32 - precision
    return _from_code(out)


# ------------------------------------------------------------------ raw16


def compress_raw(values: np.ndarray, precision: int = 16) -> bytes:
    """Uncoded truncated codes (ablation baseline, 'raw16' codec id)."""
    flat = np.ascontiguousarray(values, dtype=np.float32).reshape(-1)
    codes = _to_code(flat)
    nbytes = -(-precision // 8)
    codes >>= 32 - precision
    header = b"LRAW" + struct.pack("<BBI", VERSION, precision, flat.size)
    body = codes.astype("<u4").tobytes() if nbytes > 2 else codes.astype("<u2").tobytes()
    return header + body


def decompress_raw(data: bytes) -> np.ndarray:
    if data[:4] != b"LRAW":
        raise ValueError("not an LRAW stream")
    _, precision, count = struct.unpack_from("<BBI", data, 4)
    nbytes = -(-precision // 8)
    dt = "<u4" if nbytes > 2 else "<u2"
    codes = np.frombuffer(data[10:], dtype=dt)[:count].astype(np.uint32)
    codes = codes << (32 - precision)
    return _from_code(codes)


def compress_weights(values: np.ndarray, precision: int, codec: str = "fpz") -> bytes:
    if codec == "fpz":
        return compress(values, precision)
    if codec == "raw16":
        return compress_raw(values, precision)
    raise ValueError(f"unknown weight codec {codec!r}")


def decompress_weights(data: bytes, codec: str = "fpz") -> np.ndarray:
    if codec == "fpz":
        return decompress(data)
    if codec == "raw16":
        return decompress_raw(data)
    raise ValueError(f"unknown weight codec {codec!r}")
