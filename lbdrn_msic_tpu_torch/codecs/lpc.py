"""LPC lossless base-layer codec — Python bindings over the native library.

See codecs/native/lpc.cc for the algorithm and wire format.  This codec is
native-only (a Python mirror of a per-pixel MED+range-coder loop would be
orders of magnitude too slow); `encode_base(..., codec='jp2')` remains the
pure-Python-reachable path.
"""

from __future__ import annotations

import ctypes

import numpy as np

from lbdrn_msic_tpu_torch.codecs import _native


def _lib():
    lib = _native.load()
    if lib is None:
        raise RuntimeError(
            "native codec library unavailable (g++ build failed?); "
            "use base_codec='jp2' instead"
        )
    return lib


def encode(msb: np.ndarray, chunk_rows: int = 0) -> bytes:
    """msb: (C, H, W) uint8/uint16 -> LLPC stream.

    `chunk_rows > 0` emits the v2 row-chunked wire format: each band split
    into independent per-chunk streams so decoding parallelizes over
    C x n_chunks tasks AND chunks decode incrementally (the decode
    pipeline in decode/reconstruct.py overlaps host base decoding with
    device work).  `chunk_rows=0` keeps the v1 single-stream-per-band
    format (byte-stable; the golden fixture uses it)."""
    lib = _lib()
    if msb.ndim != 3:
        raise ValueError(f"expected CHW, got {msb.shape}")
    itemsize = msb.dtype.itemsize
    if msb.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"unsupported dtype {msb.dtype}")
    c, h, w = msb.shape
    wide = np.ascontiguousarray(msb, dtype=np.uint16)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64()
    if chunk_rows > 0 and not hasattr(lib, "lpc_compress2"):
        chunk_rows = 0  # stale pre-v2 .so whose rebuild failed: emit v1
    if chunk_rows > 0:
        rc = lib.lpc_compress2(
            wide.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            c, h, w, itemsize, chunk_rows,
            ctypes.byref(out), ctypes.byref(out_len),
        )
    else:
        rc = lib.lpc_compress(
            wide.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            c, h, w, itemsize,
            ctypes.byref(out), ctypes.byref(out_len),
        )
    if rc != 0:
        raise RuntimeError(f"lpc_compress failed rc={rc}")
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.lbdrn_free(out)


def chunk_info(data: bytes):
    """(C, H, W, itemsize, chunk_rows, n_chunks, max_val) for a v2 stream;
    None for v1 (not incrementally decodable)."""
    lib = _lib()
    if not hasattr(lib, "lpc_peek2"):
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    pdata = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    c = ctypes.c_int()
    h = ctypes.c_int()
    w = ctypes.c_int()
    itemsize = ctypes.c_int()
    if lib.lpc_peek(pdata, len(data), ctypes.byref(c), ctypes.byref(h),
                    ctypes.byref(w), ctypes.byref(itemsize)) != 0:
        raise ValueError("not an LLPC stream")
    cr = ctypes.c_int()
    nk = ctypes.c_int()
    mx = ctypes.c_int()
    if lib.lpc_peek2(pdata, len(data), ctypes.byref(cr), ctypes.byref(nk),
                     ctypes.byref(mx)) != 0:
        return None  # v1
    return (c.value, h.value, w.value, itemsize.value,
            cr.value, nk.value, mx.value)


def decode_chunk(data: bytes, ci: int, k: int, rows: int, w: int) -> np.ndarray:
    """Decode ONE (channel, chunk) of a v2 stream -> (rows, w) uint16."""
    lib = _lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty((rows, w), np.uint16)
    rc = lib.lpc_decompress_chunk(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        ci, k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out.size,
    )
    if rc != 0:
        raise RuntimeError(f"lpc_decompress_chunk({ci},{k}) failed rc={rc}")
    return out


def decode(data: bytes) -> np.ndarray:
    """LLPC stream -> (C, H, W) with the stored dtype."""
    lib = _lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    c = ctypes.c_int()
    h = ctypes.c_int()
    w = ctypes.c_int()
    itemsize = ctypes.c_int()
    pdata = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    if lib.lpc_peek(pdata, len(data), ctypes.byref(c), ctypes.byref(h),
                    ctypes.byref(w), ctypes.byref(itemsize)) != 0:
        raise ValueError("not an LLPC stream")
    out = np.empty((c.value, h.value, w.value), np.uint16)
    rc = lib.lpc_decompress(
        pdata, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.size,
    )
    if rc != 0:
        raise RuntimeError(f"lpc_decompress failed rc={rc}")
    return out.astype(np.uint8) if itemsize.value == 1 else out
