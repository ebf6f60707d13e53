"""The port's TIFF reader/writer and native chunk decoders vs the JAX
package's: `write_tiff` writes the same bytes, `read_tiff` reads the same
arrays from every file variant tests/test_io.py builds, and the port's
native LZW / PackBits decoders (its own `_native` build) agree with the
Python decoders.  All comparisons are exact."""

import os
import sys

import numpy as np
import pytest

from lbdrn_msic_tpu.io import tiff as jtiff
from lbdrn_msic_tpu_torch.codecs import _native
from lbdrn_msic_tpu_torch.io import tiff
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_native import ensure_jax_native  # noqa: E402

ensure_jax_native()  # the reference's native library: once per worker, under a lock


def _arrays(rng):
    """(name, array, write_tiff kwargs): the variants of tests/test_io.py."""
    out = []
    for dtype in (np.uint8, np.uint16, np.float32):
        for c in (1, 4, 8):
            if np.issubdtype(dtype, np.integer):
                a = rng.integers(0, np.iinfo(dtype).max, (c, 37, 53)).astype(dtype)
            else:
                a = rng.standard_normal((c, 37, 53)).astype(dtype)
            out.append((f"{np.dtype(dtype).name}x{c}", a, {}))
    out.append(("2d", rng.integers(0, 65535, (40, 30)).astype(np.uint16), {}))
    for c in (1, 4):
        for big in (False, True):
            a = rng.integers(0, 4095, (c, 70, 45)).astype(np.uint16)
            out.append((f"tiled{c}_big{big}", a, {"tile": (32, 16), "bigtiff": big}))
    out.append(("bigtiff_strips", rng.standard_normal((3, 41, 29)).astype(np.float32),
                {"rows_per_strip": 16, "bigtiff": True}))
    return out


def test_write_and_read_match_jax(tmp_path):
    for name, arr, kw in _arrays(np.random.default_rng(1234)):
        ours, ref = str(tmp_path / f"{name}_port.tif"), str(tmp_path / f"{name}_jax.tif")
        tiff.write_tiff(ours, arr, **kw)
        jtiff.write_tiff(ref, arr, **kw)
        assert open(ours, "rb").read() == open(ref, "rb").read(), name
        got, want = tiff.read_tiff(ref), jtiff.read_tiff(ref)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.reshape(arr.shape), arr)


def test_read_cv2_lzw_predictor_file_matches_jax(tmp_path):
    """A file libtiff writes (LZW + horizontal predictor) reads the same
    through both packages."""
    cv2 = pytest.importorskip("cv2")
    arr = np.random.default_rng(5).integers(0, 4095, (4, 64, 48)).astype(np.uint16)
    p = str(tmp_path / "cv.tif")
    assert cv2.imwrite(p, arr.transpose(1, 2, 0))
    np.testing.assert_array_equal(tiff.read_tiff(p), jtiff.read_tiff(p))


def test_malformed_files_fail_in_both(tmp_path):
    arr = np.random.default_rng(2).integers(0, 4095, (2, 48, 32)).astype(np.uint16)
    good = str(tmp_path / "good.tif")
    tiff.write_tiff(good, arr)
    cut = str(tmp_path / "cut.tif")
    with open(cut, "wb") as f:
        f.write(open(good, "rb").read()[: 900])
    for mod in (tiff, jtiff):
        with pytest.raises(Exception):
            mod.read_tiff(cut)


def _lzw_encode(data: bytes) -> bytes:
    """A minimal TIFF-LZW encoder (MSB-first, early change), for test
    streams only."""
    out = bytearray()
    bitbuf, bitcnt = 0, 0

    def emit(code, width):
        nonlocal bitbuf, bitcnt
        bitbuf = (bitbuf << width) | code
        bitcnt += width
        while bitcnt >= 8:
            out.append((bitbuf >> (bitcnt - 8)) & 0xFF)
            bitcnt -= 8

    table = {bytes([i]): i for i in range(256)}
    next_code, width = 258, 9
    emit(256, width)
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        emit(table[w], width)
        table[wc] = next_code
        next_code += 1
        if next_code + 1 > (1 << width) and width < 12:
            width += 1
        if next_code >= 4094:
            emit(256, width)
            table = {bytes([i]): i for i in range(256)}
            next_code, width = 258, 9
        w = bytes([ch])
    if w:
        emit(table[w], width)
    emit(257, width)
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def _packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        lit = i
        while i < n and i - lit < 128 and not (i + 1 < n and data[i + 1] == data[i]):
            i += 1
        out.append(i - lit - 1)
        out += data[lit:i]
    return bytes(out)


@pytest.mark.parametrize("codec,encode,decode", [
    ("lbdrn_lzw_decode", _lzw_encode, tiff._lzw_decode),
    ("lbdrn_packbits_decode", _packbits_encode, tiff._packbits_decode),
])
def test_native_chunk_decoders_match_python(codec, encode, decode):
    """The port's native decoders (built from its own tiffcodecs.cc) give
    the Python decoders' bytes, whole and cut at an expected size; the
    Python decoders equal the JAX package's."""
    assert _native.load() is not None, _native.load_error
    rng = np.random.default_rng(7)
    payloads = [b"A", b"ABABABABAB" * 500, bytes(rng.integers(0, 4, 5000).astype(np.uint8)),
                bytes(rng.integers(0, 256, 20000).astype(np.uint8)), bytes(10_000),
                synth_scene(64, 96, channels=2, seed=70).tobytes()]
    jdecode = getattr(jtiff, decode.__name__)
    for payload in payloads:
        stream = encode(payload)
        assert decode(stream) == payload == jdecode(stream)
        assert tiff._native_chunk_decode(codec, stream, len(payload)) == payload
        cut = len(payload) // 3
        assert tiff._native_chunk_decode(codec, stream, cut) == payload[:cut]
    assert tiff._native_chunk_decode("lbdrn_lzw_decode", bytes([0xFF] * 4), 1024) is None
