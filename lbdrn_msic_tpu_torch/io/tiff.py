"""Minimal multiband TIFF reader/writer (pure numpy).

The runtime image here has no GDAL/tifffile, so the framework carries its own
baseline-TIFF codec for the GeoTIFF-shaped inputs/outputs the reference reads
and writes through GDAL (reference LBDRNdataset.py:71-89,93; decode.py:74-76).

Scope: grayscale/multiband uint8/uint16/float32/float64; uncompressed,
Deflate, LZW or PackBits; chunky (PlanarConfiguration=1) or planar (=2);
strip- or tile-organized; classic TIFF and BigTIFF; both endiannesses on
read.  Real Gaofen GeoTIFF products are commonly tile-organized BigTIFFs
(the reference reads them through GDAL, reference LBDRNdataset.py:93).
Writes little-endian chunky uncompressed files — strip-based classic TIFF
by default, tiled and/or BigTIFF on request.  Arrays are CHW (band-major),
matching GDAL's ReadAsArray convention.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# TIFF tag ids
_W, _H = 256, 257
_BITS = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SPP = 277  # samples per pixel
_ROWS_PER_STRIP = 278
_STRIP_COUNTS = 279
_PLANAR = 284
_TILE_W = 322
_TILE_H = 323
_TILE_OFFSETS = 324
_TILE_COUNTS = 325
_EXTRA_SAMPLES = 338
_SAMPLE_FORMAT = 339

_PREDICTOR = 317

_TYPE_SIZES = {
    1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8,
    13: 4, 16: 8, 17: 8, 18: 8,  # IFD, LONG8, SLONG8, IFD8 (BigTIFF)
}


def _native_chunk_decode(fname: str, data: bytes, expected: int):
    """Decode a strip/tile with the C++ library (tiffcodecs.cc); None when
    the library is unavailable or the stream is malformed (callers fall
    back to the byte-exact Python decoders below).  `expected` is the
    decoded-size bound the TIFF geometry implies — the native decoders
    stop there, matching the [:expected] slice the callers apply."""
    import ctypes

    import numpy as np

    from lbdrn_msic_tpu_torch.codecs import _native

    lib = _native.load()
    fn = getattr(lib, fname, None) if lib is not None else None
    if fn is None or not data or expected < 0:
        return None
    if expected == 0:
        return b""
    # borrow the immutable bytes buffer (src is const in C); np.empty skips
    # the output zero-fill create_string_buffer would pay per chunk
    src = ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))
    dst = np.empty(expected, np.uint8)
    n = fn(
        src,
        ctypes.c_int64(len(data)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(expected),
    )
    if n < 0:
        return None
    return dst[:n].tobytes()


def _lzw_decode(data: bytes, expected: int | None = None) -> bytes:
    """TIFF-variant LZW (MSB-first codes, early-change).

    With `expected` set, the native C++ decoder handles the chunk (a
    Python byte-loop is ~100x too slow for production GeoTIFF reads);
    this loop is the byte-exact oracle and the portability fallback.
    Both paths cap the output at `expected` — a (malformed) strip coding
    more rows than the TIFF geometry claims truncates identically whether
    or not the native library built, so pixel output is never
    platform-dependent."""
    if expected is not None:
        out = _native_chunk_decode("lbdrn_lzw_decode", data, expected)
        if out is not None:
            return out
    CLEAR, EOI = 256, 257
    out = bytearray()
    table = None
    code_len = 9
    prev = None
    bitbuf = 0
    bitcnt = 0
    pos = 0
    n = len(data)
    while True:
        while bitcnt < code_len and pos < n:
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            bitcnt += 8
        if bitcnt < code_len:
            break
        code = (bitbuf >> (bitcnt - code_len)) & ((1 << code_len) - 1)
        bitcnt -= code_len
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            code_len = 9
            prev = None
            continue
        if code == EOI:
            break
        if table is None:
            raise ValueError("LZW stream missing initial clear code")
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if expected is not None and len(out) >= expected:
            return bytes(out[:expected])
        # early-change: bump width one code before the table fills
        if len(table) + 1 >= (1 << code_len) and code_len < 12:
            code_len += 1
    return bytes(out)


def _packbits_decode(data: bytes, expected: int | None = None) -> bytes:
    if expected is not None:
        nat = _native_chunk_decode("lbdrn_packbits_decode", data, expected)
        if nat is not None:
            return nat
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        b = data[i]
        i += 1
        if b < 128:
            out += data[i : i + b + 1]
            i += b + 1
        elif b > 128:
            out += data[i : i + 1] * (257 - b)
            i += 1
        if expected is not None and len(out) >= expected:
            return bytes(out[:expected])  # cap as the native decoder does
    return bytes(out)


def _read_ifd_entries(buf: bytes, off: int, en: str, big: bool = False):
    """Parse one IFD.  Classic entries are 12 bytes with 4-byte inline values;
    BigTIFF entries are 20 bytes with 8-byte counts and inline values."""
    if big:
        (count,) = struct.unpack_from(en + "Q", buf, off)
        first, esize, inline, offt = off + 8, 20, 8, "Q"
    else:
        (count,) = struct.unpack_from(en + "H", buf, off)
        first, esize, inline, offt = off + 2, 12, 4, "I"
    entries = {}
    for i in range(count):
        ent = first + i * esize
        if big:
            tag, typ, n = struct.unpack_from(en + "HHQ", buf, ent)
        else:
            tag, typ, n = struct.unpack_from(en + "HHI", buf, ent)
        val_off = ent + esize - inline
        size = _TYPE_SIZES.get(typ, 1) * n
        if size > inline:
            (ptr,) = struct.unpack_from(en + offt, buf, val_off)
            raw = buf[ptr : ptr + size]
        else:
            raw = buf[val_off : val_off + inline][:size]
        if typ == 3:
            vals = list(struct.unpack(en + f"{n}H", raw))
        elif typ in (4, 13):
            vals = list(struct.unpack(en + f"{n}I", raw))
        elif typ in (16, 18):  # LONG8 / IFD8
            vals = list(struct.unpack(en + f"{n}Q", raw))
        elif typ == 17:  # SLONG8
            vals = list(struct.unpack(en + f"{n}q", raw))
        elif typ == 1:
            vals = list(raw)
        elif typ == 5:  # rational
            parts = struct.unpack(en + f"{2*n}I", raw)
            vals = [parts[2 * k] / max(parts[2 * k + 1], 1) for k in range(n)]
        else:
            vals = [raw]
        entries[tag] = vals
    (next_ifd,) = struct.unpack_from(en + offt, buf, first + count * esize)
    return entries, next_ifd


def read_tiff(path: str) -> np.ndarray:
    """Read a TIFF file into a CHW numpy array (HW squeezed to 1 band kept as CHW).

    Handles both strip- and tile-organized images, classic TIFF (magic 42)
    and BigTIFF (magic 43, 8-byte offsets) — the layouts GDAL emits for the
    large Gaofen products the reference loads (reference LBDRNdataset.py:93).
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] == b"II":
        en = "<"
    elif buf[:2] == b"MM":
        en = ">"
    else:
        raise ValueError(f"{path}: not a TIFF file")
    (magic,) = struct.unpack_from(en + "H", buf, 2)
    if magic == 42:
        big = False
        (ifd_off,) = struct.unpack_from(en + "I", buf, 4)
    elif magic == 43:
        big = True
        offsize, reserved = struct.unpack_from(en + "HH", buf, 4)
        if offsize != 8 or reserved != 0:
            raise ValueError(f"{path}: bad BigTIFF header ({offsize}, {reserved})")
        (ifd_off,) = struct.unpack_from(en + "Q", buf, 8)
    else:
        raise ValueError(f"{path}: bad TIFF magic {magic}")
    e, _ = _read_ifd_entries(buf, ifd_off, en, big)

    width, height = e[_W][0], e[_H][0]
    spp = e.get(_SPP, [1])[0]
    bits = e.get(_BITS, [1])[0]
    comp = e.get(_COMPRESSION, [1])[0]
    planar = e.get(_PLANAR, [1])[0]
    sfmt = e.get(_SAMPLE_FORMAT, [1])[0]

    if comp not in (1, 5, 8, 32773, 32946):
        raise ValueError(f"{path}: unsupported TIFF compression {comp}")
    predictor = e.get(_PREDICTOR, [1])[0]
    if sfmt == 1:
        dtype = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits]
    elif sfmt == 2:
        dtype = {8: np.int8, 16: np.int16, 32: np.int32}[bits]
    elif sfmt == 3:
        dtype = {32: np.float32, 64: np.float64}[bits]
    else:
        raise ValueError(f"{path}: unsupported sample format {sfmt}")
    dtype = np.dtype(dtype).newbyteorder(en)

    def decode_chunk(off: int, cnt: int, expected: int) -> bytes:
        chunk = buf[off : off + cnt]
        if comp in (8, 32946):
            return zlib.decompress(chunk)
        if comp == 5:
            return _lzw_decode(chunk, expected)
        if comp == 32773:
            return _packbits_decode(chunk, expected)
        return chunk

    def undo_predictor(rows: np.ndarray) -> np.ndarray:
        # horizontal differencing resets each row; channels are independent
        if predictor != 2:
            return rows
        return np.cumsum(rows.astype(np.int64), axis=1).astype(rows.dtype)

    if _TILE_OFFSETS in e:
        tw, th = e[_TILE_W][0], e[_TILE_H][0]
        offsets, counts = e[_TILE_OFFSETS], e[_TILE_COUNTS]
        tiles_across = -(-width // tw)
        tiles_down = -(-height // th)
        planes = spp if planar == 2 else 1
        cps = spp if planar == 1 else 1  # interleaved channels inside a tile
        if len(offsets) != planes * tiles_down * tiles_across:
            raise ValueError(f"{path}: tile count mismatch")
        out = np.zeros((planes, height, width, cps), dtype.newbyteorder("="))
        idx = 0
        for p in range(planes):
            for ty in range(tiles_down):
                for tx in range(tiles_across):
                    raw = decode_chunk(
                        offsets[idx], counts[idx],
                        th * tw * cps * dtype.itemsize,
                    )
                    idx += 1
                    tile = np.frombuffer(raw, dtype=dtype)[: th * tw * cps]
                    tile = tile.astype(dtype.newbyteorder("=")).reshape(th, tw, cps)
                    tile = undo_predictor(tile)
                    h0, w0 = ty * th, tx * tw
                    hs, ws = min(th, height - h0), min(tw, width - w0)
                    out[p, h0 : h0 + hs, w0 : w0 + ws] = tile[:hs, :ws]
        if planar == 1:
            arr = out[0].transpose(2, 0, 1)
        else:
            arr = out[..., 0]
        return np.ascontiguousarray(arr)

    offsets = e[_STRIP_OFFSETS]
    counts = e[_STRIP_COUNTS]
    total = height * width * spp * dtype.itemsize
    # per-strip decoded-size bound: RowsPerStrip rows (last strip shorter);
    # the remaining-bytes cap alone would allocate a near-total-size output
    # buffer per strip (quadratic zeroing over hundreds of strips)
    rps = e.get(_ROWS_PER_STRIP, [height])[0]
    strip_bytes = rps * width * (spp if planar == 1 else 1) * dtype.itemsize
    data = bytearray()
    for off, cnt in zip(offsets, counts):
        data += decode_chunk(
            off, cnt, max(0, min(strip_bytes, total - len(data)))
        )
    arr = np.frombuffer(bytes(data), dtype=dtype)
    arr = arr.astype(dtype.newbyteorder("="))
    n = height * width * spp
    if predictor == 2:
        if planar == 1:
            arr = undo_predictor(arr[:n].reshape(height, width * spp).reshape(height, width, spp)).ravel()
        else:
            arr = undo_predictor(arr[:n].reshape(spp * height, width)).ravel()

    if planar == 1:
        arr = arr[:n].reshape(height, width, spp).transpose(2, 0, 1)
    else:
        # planar: strips cover band 0's rows, then band 1's, ...
        arr = arr[:n].reshape(spp, height, width)
    return np.ascontiguousarray(arr)


def write_tiff(
    path: str,
    array: np.ndarray,
    rows_per_strip: int = 256,
    tile: tuple[int, int] | None = None,
    bigtiff: bool = False,
) -> None:
    """Write a CHW (or HW) array as a chunky little-endian uncompressed TIFF.

    Mirrors the role of the reference's ``write_tiff_with_gdal``
    (reference LBDRNdataset.py:71-89).  ``tile=(th, tw)`` writes a
    tile-organized file (dimensions must be multiples of 16, per spec);
    ``bigtiff=True`` writes the 8-byte-offset BigTIFF layout (required past
    4 GiB; GDAL's default for large Gaofen products).
    """
    if array.ndim == 2:
        array = array[None]
    if array.ndim != 3:
        raise ValueError(f"expected CHW array, got shape {array.shape}")
    c, h, w = array.shape
    dt = array.dtype
    if dt == np.uint8:
        bits, sfmt = 8, 1
    elif dt == np.uint16:
        bits, sfmt = 16, 1
    elif dt == np.float32:
        bits, sfmt = 32, 3
    elif dt == np.float64:
        bits, sfmt = 64, 3
    else:
        raise ValueError(f"unsupported dtype {dt}")

    hwc = np.ascontiguousarray(array.transpose(1, 2, 0).astype(dt.newbyteorder("<")))

    chunks = []
    if tile is not None:
        th, tw = tile
        if th % 16 or tw % 16:
            raise ValueError(f"tile dims must be multiples of 16, got {tile}")
        for ty in range(-(-h // th)):
            for tx in range(-(-w // tw)):
                block = np.zeros((th, tw, c), hwc.dtype)
                hs = min(th, h - ty * th)
                ws = min(tw, w - tx * tw)
                block[:hs, :ws] = hwc[ty * th : ty * th + hs, tx * tw : tx * tw + ws]
                chunks.append(block.tobytes())
    else:
        for s in range(-(-h // rows_per_strip)):
            r0, r1 = s * rows_per_strip, min((s + 1) * rows_per_strip, h)
            chunks.append(hwc[r0:r1].tobytes())
    n_chunks = len(chunks)

    # LONG in classic files, LONG8 in BigTIFF, for offsets/counts
    offt = 16 if bigtiff else 4
    photometric = 1  # BlackIsZero
    tags = [
        (_W, 4, 1, [w]),
        (_H, 4, 1, [h]),
        (_BITS, 3, c, [bits] * c),
        (_COMPRESSION, 3, 1, [1]),
        (_PHOTOMETRIC, 3, 1, [photometric]),
        (_SPP, 3, 1, [c]),
        (_PLANAR, 3, 1, [1]),
        (_SAMPLE_FORMAT, 3, c, [sfmt] * c),
    ]
    if tile is not None:
        tags += [
            (_TILE_W, 4, 1, [tile[1]]),
            (_TILE_H, 4, 1, [tile[0]]),
            (_TILE_OFFSETS, offt, n_chunks, None),  # filled below
            (_TILE_COUNTS, offt, n_chunks, [len(s) for s in chunks]),
        ]
        offsets_tag = _TILE_OFFSETS
    else:
        tags += [
            (_STRIP_OFFSETS, offt, n_chunks, None),
            (_ROWS_PER_STRIP, 4, 1, [rows_per_strip]),
            (_STRIP_COUNTS, offt, n_chunks, [len(s) for s in chunks]),
        ]
        offsets_tag = _STRIP_OFFSETS
    if c > 1:
        # Mark non-first bands as unassociated extra samples so libtiff-based
        # readers (cv2 etc.) keep all SamplesPerPixel channels.
        tags.append((_EXTRA_SAMPLES, 3, c - 1, [0] * (c - 1)))
    tags.sort(key=lambda t: t[0])

    # layout: header | IFD | overflow values | chunk data
    if bigtiff:
        header = b"II" + struct.pack("<HHHQ", 43, 8, 0, 16)
        # 8-byte IFD entry tally, 8-byte per-entry counts, 8-byte offsets
        ifd_off, esize, inline, leadfmt, cntfmt, offfmt = 16, 20, 8, "Q", "Q", "Q"
    else:
        header = b"II" + struct.pack("<HI", 42, 8)
        ifd_off, esize, inline, leadfmt, cntfmt, offfmt = 8, 12, 4, "H", "I", "I"
    ifd_size = struct.calcsize("<" + leadfmt) + len(tags) * esize + struct.calcsize("<" + offfmt)
    overflow_off = ifd_off + ifd_size
    overflow = bytearray()

    def value_bytes(typ, vals):
        fmt = {3: "H", 4: "I", 1: "B", 16: "Q"}[typ]
        return struct.pack(f"<{len(vals)}{fmt}", *vals)

    # first pass to size the overflow area (chunk offsets resolved after)
    data_off = overflow_off
    for tag, typ, n, vals in tags:
        size = _TYPE_SIZES[typ] * n
        if size > inline:
            data_off += size
    chunk_offsets = []
    acc = data_off
    for s in chunks:
        chunk_offsets.append(acc)
        acc += len(s)

    out = bytearray(header)
    ifd = bytearray(struct.pack("<" + leadfmt, len(tags)))
    ov_cursor = overflow_off
    for tag, typ, n, vals in tags:
        if tag == offsets_tag:
            vals = chunk_offsets
        raw = value_bytes(typ, vals)
        if len(raw) > inline:
            ifd += struct.pack(f"<HH{cntfmt}{offfmt}", tag, typ, n, ov_cursor)
            overflow += raw
            ov_cursor += len(raw)
        else:
            ifd += struct.pack(f"<HH{cntfmt}", tag, typ, n) + raw.ljust(inline, b"\x00")
    ifd += struct.pack("<" + offfmt, 0)
    out += ifd
    out += overflow
    assert len(out) == data_off, (len(out), data_off)
    for s in chunks:
        out += s
    with open(path, "wb") as f:
        f.write(out)
