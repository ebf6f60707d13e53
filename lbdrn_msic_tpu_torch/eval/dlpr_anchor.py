"""Harness for the DLPR near-lossless anchor (reference DLPR_nll.py).

The reference's DLPR anchor is a *hybrid*: the first 3 bands go through the
external DLPR repo's learned near-lossless codec at threshold tau, the
remaining bands through cjxl; big scenes are processed in 3000x3000 blocks
and packed into a small struct container, and an RD/timing loop sweeps 11
rate points (reference DLPR_nll.py:300-664).

The external DLPR network and cjxl binaries are not part of this runtime,
so the codec callbacks are injectable: pass `dl_codec` (3-band block codec)
and optionally `extra_codec`; the blocking, container, sweep, and RD logic
here are fully functional and covered by tests with mock codecs.
"""

from __future__ import annotations

import csv
import os
import struct
import sys
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from lbdrn_msic_tpu_torch.eval.metrics import PSNR_PEAK

BLOCK = 3000  # reference DLPR_nll.py's big-file blocking

# default checkout location, matching the reference's symlink convention
# (reference DLPR_nll.py:26); override with the DLPR_REPO env var
DLPR_REPO_DEFAULT = "Deep-Lossy-Plus-Residual-Coding/DLPR_nll"


def dlpr_repo_dir() -> str:
    return os.environ.get("DLPR_REPO", DLPR_REPO_DEFAULT)


def external_dlpr_available(repo_dir: str | None = None) -> bool:
    """True when the external DLPR checkout (nll_test.py entry point) is
    present — the gate for the real learned codec vs the substitute."""
    d = repo_dir or dlpr_repo_dir()
    return os.path.isfile(os.path.join(d, "nll_test.py"))


def external_dl_codec(
    tau: int, repo_dir: str | None = None, nll_model=None
) -> Tuple[DLCodec, DLDecode]:
    """(encode, decode) over (3, h, w) uint16 blocks via the REAL external
    DLPR near-lossless codec (reference DLPR_nll.py:300-370: sys.path the
    repo, call its nll_test compress/decompress with the 7x7 coding-order
    table).  DLPR consumes float32 HWC in [0,255]-ish range trained on
    8-bit imagery, so 16-bit bands ride the reference's MSB/LSB byte split.

    Requires the repo checkout (+ its pretrained weights and compressai);
    callers gate on external_dlpr_available().  `nll_model` may be passed
    pre-loaded to amortize weight loading across blocks/taus.
    """
    d = repo_dir or dlpr_repo_dir()
    if not external_dlpr_available(d):
        raise RuntimeError(
            f"external DLPR repo not found at {d}; clone "
            "Deep-Lossy-Plus-Residual-Coding (or set DLPR_REPO) to enable "
            "the real anchor — eval.dlpr_anchor works end-to-end with a "
            "substitute codec otherwise"
        )
    if d not in sys.path:
        sys.path.insert(0, d)
    from nll_test import coding_order_table7x7, compress, decompress  # type: ignore

    if nll_model is None:
        from nll_model_eval import NearLosslessCompressor  # type: ignore

        nll_model = NearLosslessCompressor()
    cot = coding_order_table7x7()

    def enc(block: np.ndarray) -> bytes:
        hwc = block.transpose(1, 2, 0).astype(np.float32)
        code_lossy, code_res, img_shape, res_range = compress(
            nll_model, hwc, cot, tau
        )
        # the reference writes these through write_ints/write_body into a
        # temp file (DLPR_nll.py:309-325); pack the same fields here
        out = bytearray(struct.pack("<II", *img_shape[2:]))
        parts = (
            list(code_lossy["img_strings"][0])
            + list(code_lossy["img_strings"][1])
            + list(code_res)
        )
        out += struct.pack(
            "<III",
            len(code_lossy["img_strings"][0]),
            len(code_lossy["img_strings"][1]),
            len(code_res),
        )
        out += struct.pack("<ii", *res_range)
        for p in parts:
            out += struct.pack("<I", len(p))
            out += p
        return bytes(out)

    def dec(data: bytes) -> np.ndarray:
        h, w = struct.unpack_from("<II", data, 0)
        n_y, n_z, n_res = struct.unpack_from("<III", data, 8)
        res_range = list(struct.unpack_from("<ii", data, 20))
        ptr = 28
        parts = []
        for _ in range(n_y + n_z + n_res):
            (ln,) = struct.unpack_from("<I", data, ptr)
            ptr += 4
            parts.append(data[ptr : ptr + ln])
            ptr += ln
        code_lossy = {
            "img_strings": [parts[:n_y], parts[n_y : n_y + n_z]],
            "shape": [1, 3, h, w],
        }
        code_res = parts[n_y + n_z :]
        hwc = decompress(nll_model, code_lossy, code_res, res_range, cot, tau)
        return np.asarray(hwc).transpose(2, 0, 1).astype(np.uint16)

    return enc, dec

# (encode, decode) over a (3, h, w) uint16 block; encode -> bytes
DLCodec = Callable[[np.ndarray], bytes]
DLDecode = Callable[[bytes], np.ndarray]


def _blocks(h: int, w: int) -> List[Tuple[int, int, int, int]]:
    out = []
    for y0 in range(0, h, BLOCK):
        for x0 in range(0, w, BLOCK):
            out.append((y0, x0, min(BLOCK, h - y0), min(BLOCK, w - x0)))
    return out


def encode_hybrid(
    img: np.ndarray,
    dl_encode: DLCodec,
    extra_encode: Callable[[np.ndarray], bytes],
) -> bytes:
    """Container: u8 C | u32 H | u32 W | u32 n_chunks | (u32 len ‖ payload)*.

    First-3-band blocks (row-major) via dl_encode, then one chunk for the
    extra bands via extra_encode.
    """
    C, H, W = img.shape
    chunks: List[bytes] = []
    for y0, x0, bh, bw in _blocks(H, W):
        chunks.append(dl_encode(np.ascontiguousarray(img[:3, y0 : y0 + bh, x0 : x0 + bw])))
    if C > 3:
        chunks.append(extra_encode(np.ascontiguousarray(img[3:])))
    out = bytearray(struct.pack("<BII I", C, H, W, len(chunks)))
    for ch in chunks:
        out += struct.pack("<I", len(ch))
        out += ch
    return bytes(out)


def decode_hybrid(
    data: bytes,
    dl_decode: DLDecode,
    extra_decode: Callable[[bytes], np.ndarray],
) -> np.ndarray:
    C, H, W, n_chunks = struct.unpack_from("<BII I", data, 0)
    ptr = struct.calcsize("<BII I")
    chunks = []
    for _ in range(n_chunks):
        (ln,) = struct.unpack_from("<I", data, ptr)
        ptr += 4
        chunks.append(data[ptr : ptr + ln])
        ptr += ln
    out = np.zeros((C, H, W), np.uint16)
    blocks = _blocks(H, W)
    for (y0, x0, bh, bw), ch in zip(blocks, chunks):
        out[:3, y0 : y0 + bh, x0 : x0 + bw] = dl_decode(ch)
    if C > 3:
        out[3:] = extra_decode(chunks[len(blocks)])
    return out


def sweep_rd(
    images: Dict[str, np.ndarray],
    taus: Sequence[int],
    make_dl_codec: Callable[[int], Tuple[DLCodec, DLDecode]],
    extra_encode: Callable[[np.ndarray], bytes],
    extra_decode: Callable[[bytes], np.ndarray],
    out_csv: str,
) -> str:
    """Per-(image, tau) RD + wall-time sweep -> reference DLPR_nll CSV shape
    (rows = rate points, columns {image}_{MSE,PSNR,bpsp,bits})."""
    names = list(images)
    metrics = ["MSE", "PSNR", "bpsp", "bits"]
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tau"] + [f"{n}_{m}" for n in names for m in metrics])
        for tau in taus:
            enc, dec = make_dl_codec(tau)
            row: list = [f"tau{tau}"]
            for n in names:
                img = images[n]
                t0 = time.time()
                stream = encode_hybrid(img, enc, extra_encode)
                t_enc = time.time() - t0
                t0 = time.time()
                rec = decode_hybrid(stream, dec, extra_decode)
                t_dec = time.time() - t0
                mse = float(np.mean((img.astype(np.float32) - rec.astype(np.float32)) ** 2))
                psnr = float(10 * np.log10(PSNR_PEAK**2 / mse)) if mse else float("inf")
                bits = 8 * len(stream)
                row += [mse, psnr, bits / img.size, bits]
                print(f"[dlpr] {n} tau={tau}: {psnr:.2f} dB "
                      f"enc {t_enc:.2f}s dec {t_dec:.2f}s")
            w.writerow(row)
    return out_csv


def results_to_csv(
    names: Sequence[str],
    psnr_grid: np.ndarray,
    bpsp_grid: np.ndarray,
    subpixels: Sequence[int],
    out_csv: str,
) -> str:
    """Measured-numbers -> CSV (the role of reference DLPR_nll_results.py:73-130:
    turning externally measured psnr/bpsp arrays into the canonical CSV)."""
    n_pts = psnr_grid.shape[1]
    metrics = ["MSE", "PSNR", "bpsp", "bits"]
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["P"] + [f"{n}_{m}" for n in names for m in metrics])
        for r in range(n_pts):
            row: list = [f"P{r+1}"]
            for i, n in enumerate(names):
                psnr = psnr_grid[i, r]
                mse = PSNR_PEAK**2 / (10 ** (psnr / 10))
                bpsp = bpsp_grid[i, r]
                row += [mse, psnr, bpsp, bpsp * subpixels[i]]
            w.writerow(row)
    return out_csv
