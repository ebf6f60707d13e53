"""Classical anchor codecs for RD comparison (reference SOTA.py:40-242).

Four anchors, matching the reference's constructions:

- **Baseline** — drop the K LSBs, code the MSB plane losslessly; decode as
  ``MSB << K`` (reference SOTA.py:41-64, zero-LSB decode :145-146).
- **JPEG2000star** — lossless JP2 of the MSB + *lossy* JP2 of the LSB plane
  at quality q = 2K percent (reference SOTA.py:41-74).
- **JPEG2000** — direct lossy JP2 of the 16-bit image with the reference's
  per-K quality table (reference SOTA.py:76-84).
- **JPEGXL** — per-band cjxl with the reference's distance table
  (reference SOTA.py:86-115); gated on the cjxl/djxl CLIs being present.

JPEG 2000 runs through OpenCV's OpenJPEG binding.  GDAL's JP2OpenJPEG
``QUALITY=q`` (percent) maps to OpenCV's ``IMWRITE_JPEG2000_COMPRESSION_X1000
= 10*q`` (both express target ratio: 100/q vs 1000/x).  Streams use this
framework's band-grouped container (cv2 codes <= 4 bands per codestream), so
anchor *bitstreams* are not byte-compatible with the reference's — the RD
points are the comparable artifact.
"""

from __future__ import annotations

import functools
import os
import shutil
import struct
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from lbdrn_msic_tpu_torch.codecs.base_layer import _band_groups, decode_base, encode_base
from lbdrn_msic_tpu_torch.eval.metrics import PSNR_PEAK

# reference SOTA.py:80 (JPEG2000) and :87 (JPEGXL distance), K=1..11
JPEG2000_QUALITY = [43.5, 33.5, 28, 22, 16, 11.5, 10, 8, 6, 4, 2]
JPEGXL_DISTANCE = [0.01, 0.015, 0.02, 0.025, 0.03, 0.04, 0.06, 0.08, 0.12, 0.16, 0.24]

METHODS = ("Baseline", "JPEG2000star", "JPEG2000", "JPEGXL")


def _jp2_lossy_groups(img: np.ndarray, quality_percent: float) -> bytes:
    """Band-grouped lossy JP2 container (mirrors base_layer's lossless one)."""
    import cv2

    c = img.shape[0]
    groups = _band_groups(c)
    x1000 = max(1, min(1000, int(round(quality_percent * 10))))
    payloads = []
    i = 0
    for g in groups:
        hwc = np.ascontiguousarray(img[i : i + g].transpose(1, 2, 0))
        i += g
        if g == 1:
            hwc = hwc[:, :, 0]
        ok, buf = cv2.imencode(".jp2", hwc, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000])
        if not ok:
            raise RuntimeError("cv2 JPEG2000 encode failed")
        payloads.append(bytes(buf))
    out = bytearray(b"LJ2L")
    out.append(1)
    out.append(len(groups))
    out.append(1 if img.dtype == np.uint8 else 2)
    for g, pl in zip(groups, payloads):
        out.append(g)
        out += struct.pack("<I", len(pl))
    for pl in payloads:
        out += pl
    return bytes(out)


def _jp2_lossy_decode(data: bytes) -> np.ndarray:
    import cv2

    assert data[:4] == b"LJ2L" and data[4] == 1
    n_groups, itemsize = data[5], data[6]
    ptr = 7
    groups, sizes = [], []
    for _ in range(n_groups):
        groups.append(data[ptr])
        sizes.append(struct.unpack_from("<I", data, ptr + 1)[0])
        ptr += 5
    bands = []
    for g, sz in zip(groups, sizes):
        img = cv2.imdecode(np.frombuffer(data[ptr : ptr + sz], np.uint8),
                           cv2.IMREAD_UNCHANGED)
        ptr += sz
        if img is None:
            raise RuntimeError("cv2 JPEG2000 decode failed")
        if img.ndim == 2:
            img = img[:, :, None]
        bands.append(img.transpose(2, 0, 1))
    out = np.concatenate(bands, 0)
    return out.astype(np.uint8 if itemsize == 1 else np.uint16, copy=False)


def jpegxl_available() -> bool:
    return shutil.which("cjxl") is not None and shutil.which("djxl") is not None


def anchor_encode(
    img: np.ndarray, method: str, K: int = 1,
    q: Optional[float] = None, d: Optional[float] = None,
    jxl_band_codec=None,
) -> bytes:
    """img: (C, H, W) uint16 -> anchor bitstream.

    Header layouts mirror the reference's mini formats (SOTA.py:51-58):
    Baseline: [1B header_len][1B K]; JPEG2000star: [1B][4B msb_len][1B K].
    """
    if method in ("Baseline", "JPEG2000star"):
        msb = img >> K
        msb = msb.astype(np.uint8) if msb.max() <= 255 else msb.astype(np.uint16)
        msb_stream = encode_base(msb, "jp2")
        out = bytearray()
        if method == "JPEG2000star":
            out.append(6)
            out += len(msb_stream).to_bytes(4, "big")
            out.append(K)
            out += msb_stream
            lsb = (img - (msb.astype(np.uint16) << K)).astype(np.uint16)
            lsb = lsb.astype(np.uint8) if lsb.max() <= 255 else lsb
            out += _jp2_lossy_groups(lsb, 2 * K if q is None else q)
        else:
            out.append(2)
            out.append(K)
            out += msb_stream
        return bytes(out)
    if method == "JPEG2000":
        return _jp2_lossy_groups(img, JPEG2000_QUALITY[K - 1] if q is None else q)
    if method == "JPEGXL":
        return _jpegxl_encode(
            img, JPEGXL_DISTANCE[K - 1] if d is None else d,
            band_codec=jxl_band_codec,
        )
    raise ValueError(f"unknown anchor method {method!r}")


def anchor_decode(data: bytes, method: str, jxl_band_codec=None) -> np.ndarray:
    if method in ("Baseline", "JPEG2000star"):
        n_hdr = data[0]
        if method == "JPEG2000star":
            msb_len = int.from_bytes(data[1:5], "big")
            K = data[5]
            msb = decode_base(data[6 : 6 + msb_len], "jp2").astype(np.uint16)
            lsb = _jp2_lossy_decode(data[6 + msb_len :]).astype(np.uint16)
        else:
            K = data[1]
            msb = decode_base(data[2:], "jp2").astype(np.uint16)
            lsb = np.zeros_like(msb)
        assert n_hdr in (2, 6)
        return ((msb << K) + lsb).astype(np.uint16)
    if method == "JPEG2000":
        return _jp2_lossy_decode(data).astype(np.uint16)
    if method == "JPEGXL":
        return _jpegxl_decode(data, band_codec=jxl_band_codec)
    raise ValueError(f"unknown anchor method {method!r}")


def _cjxl_band_encode(band: np.ndarray, distance: float, effort: int = 7) -> bytes:
    """One band through the real cjxl CLI (reference SOTA.py:95)."""
    import cv2

    with tempfile.TemporaryDirectory() as td:
        png = os.path.join(td, "band.png")
        jxl = os.path.join(td, "band.jxl")
        cv2.imwrite(png, band)
        subprocess.run(
            ["cjxl", png, jxl, "-e", str(effort), "-d", str(distance)],
            check=True, capture_output=True,
        )
        with open(jxl, "rb") as f:
            return f.read()


def _djxl_band_decode(data: bytes) -> np.ndarray:
    import cv2

    with tempfile.TemporaryDirectory() as td:
        jxl = os.path.join(td, "band.jxl")
        png = os.path.join(td, "band.png")
        with open(jxl, "wb") as f:
            f.write(data)
        subprocess.run(["djxl", jxl, png], check=True, capture_output=True)
        return cv2.imread(png, cv2.IMREAD_UNCHANGED)


def jxl_substitute_band_codec():
    """In-repo stand-in for cjxl/djxl: a uniform quantizer (step derived
    monotonically from the butteraugli distance knob) whose indices are
    losslessly coded by the native LPC coder.

    This is NOT JPEG XL — it exists so the JPEGXL anchor slot (container
    layout, per-band sizes, RD sweep, CSV emission) runs end-to-end in
    runtimes without the libjxl CLIs; results are labeled JPEGXLsub.
    Returns (encode(band, distance) -> bytes, decode(bytes) -> band).
    """
    from lbdrn_msic_tpu_torch.codecs import lpc

    def enc(band: np.ndarray, distance: float) -> bytes:
        # reference distances 0.01..0.24 (SOTA.py:87) -> steps 20..491 on
        # 16-bit samples: spans a PSNR ladder comparable to the real table;
        # clamped to the 2-byte header field (distance > ~32 saturates)
        step = min(max(1, int(round(distance * 2048))), 0xFFFF)
        idx = ((band.astype(np.int32) + step // 2) // step).astype(np.uint16)
        return step.to_bytes(2, "big") + lpc.encode(idx[None])

    def dec(data: bytes) -> np.ndarray:
        step = int.from_bytes(data[:2], "big")
        idx = lpc.decode(data[2:]).astype(np.int32)
        return np.clip(idx[0] * step, 0, 65535).astype(np.uint16)

    return enc, dec


def _jpegxl_encode(
    img: np.ndarray, distance: float, effort: int = 7, band_codec=None
) -> bytes:
    """Per-band coding, 4-byte band lengths (reference SOTA.py:86-115).

    `band_codec`: optional (encode, decode) pair replacing the cjxl CLI —
    see jxl_substitute_band_codec.  The container layout is identical
    either way.
    """
    if band_codec is None:
        if not jpegxl_available():
            raise RuntimeError(
                "cjxl/djxl not found on PATH; JPEGXL anchor unavailable "
                "(use jxl_substitute_band_codec() for the substitute)"
            )
        enc = functools.partial(_cjxl_band_encode, effort=effort)
    else:
        enc = band_codec[0]
    c = img.shape[0]
    payloads = [enc(img[b], distance) for b in range(c)]
    out = bytearray()
    out.append(2 + 4 * (c - 1))
    out.append(c)
    for pl in payloads[:-1]:
        out += len(pl).to_bytes(4, "big")
    for pl in payloads:
        out += pl
    return bytes(out)


def _jpegxl_decode(data: bytes, band_codec=None) -> np.ndarray:
    if band_codec is None:
        if not jpegxl_available():
            raise RuntimeError(
                "cjxl/djxl not found on PATH; JPEGXL anchor unavailable "
                "(use jxl_substitute_band_codec() for the substitute)"
            )
        dec = _djxl_band_decode
    else:
        dec = band_codec[1]
    c = data[1]
    ptr = 2
    sizes = []
    for _ in range(c - 1):
        sizes.append(int.from_bytes(data[ptr : ptr + 4], "big"))
        ptr += 4
    rest = data[ptr:]
    bands = []
    for b in range(c):
        chunk = rest[: sizes[b]] if b < c - 1 else rest
        if b < c - 1:
            rest = rest[sizes[b] :]
        bands.append(dec(chunk))
    return np.stack(bands, 0).astype(np.uint16)


def eval_rd(img: np.ndarray, stream: bytes, recon: np.ndarray) -> Tuple[float, float, int, float]:
    """(MSE, PSNR@peak10000, bits, bpsp) — reference SOTA.py:183-194."""
    mse = float(np.mean((img.astype(np.float32) - recon.astype(np.float32)) ** 2))
    psnr = float(10 * np.log10(PSNR_PEAK**2 / mse)) if mse > 0 else float("inf")
    bits = 8 * len(stream)
    return mse, psnr, bits, bits / float(np.prod(img.shape))


def sweep_to_csv(
    images: dict[str, np.ndarray], method: str, out_csv: str,
    k_min: int = 1, k_max: int = 11, jxl_band_codec=None,
) -> str:
    """RD sweep -> CSV in the reference's {method}_11rps.csv schema
    (rows K1..K11, columns {name}_{MSE,PSNR,bpsp,bits})."""
    import csv

    names = list(images)
    metrics = ["MSE", "PSNR", "bpsp", "bits"]
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["K"] + [f"{n}_{m}" for n in names for m in metrics])
        for K in range(k_min, k_max + 1):
            row = [f"K{K}"]
            for n in names:
                img = images[n]
                stream = anchor_encode(img, method, K, jxl_band_codec=jxl_band_codec)
                recon = anchor_decode(stream, method, jxl_band_codec=jxl_band_codec)
                mse, psnr, bits, bpsp = eval_rd(img, stream, recon)
                row += [mse, psnr, bpsp, bits]
            w.writerow(row)
    return out_csv
