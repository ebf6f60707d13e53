"""Drive the BitMore/ABCD, DLPR and JPEG-XL anchor harnesses end to end
with simple in-repo substitute codecs, the counterpart of
scripts/substitute_anchors.py.  Host only: no stage touches the device.

The reference's learned anchors live in external repositories whose
checkpoints are absent here (reference SOTA_BDR.py:35-251,
DLPR_nll.py:300-664).  This script runs every stage of their harnesses
(div tiling, PNG round trips, reassembly, masking, 3000x3000 blocking, the
hybrid container, the RD sweep, the CSVs) with genuine, deliberately weak
codecs:

- BitMore/ABCD slot: the classical half-step bit-depth recovery (mask to
  in_bits, restore the dropped range's midpoint); the grid CSV has the
  reference's test_* shape.  Needs OpenCV (the divs are PNGs).
- DLPR slot: uniform quantisation with bin half-width tau over the first 3
  bands (DLPR's |error| <= tau guarantee), indices coded by the LPC coder;
  extra bands LPC-lossless.  tau=0 is exactly lossless.
- JPEG-XL slot: the per-band container and sweep (reference
  SOTA.py:86-115) with `eval.anchors.jxl_substitute_band_codec` (uniform
  quantiser + LPC), in the reference CSV schema.

    python -m lbdrn_msic_tpu_torch.scripts.substitute_anchors [--size 256]
        [--scenes 2] [--out out/validation] [--device cuda|cpu]

`--device` defaults to cuda, as every entry point of the port: the run
stops without CUDA unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from lbdrn_msic_tpu_torch.scripts.suite import OUT_DEFAULT


def halfstep_model(div_dir: str, in_bits: int) -> None:
    """The classical BDR baseline as a drop-in external model: read each
    div PNG, mask to in_bits, set the dropped range's midpoint, write the
    _output.png the reassembler expects."""
    import cv2

    for fn in sorted(os.listdir(div_dir)):
        if not fn.endswith(".png") or fn.endswith("_output.png"):
            continue
        p = os.path.join(div_dir, fn)
        tile = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        mask = np.uint16(int("1" * in_bits + "0" * (16 - in_bits), 2))
        half = np.uint16(1 << (16 - in_bits - 1)) if in_bits < 16 else np.uint16(0)
        out = (tile & mask) | half
        cv2.imwrite(p.replace(".png", "_output.png"), out)


def make_quantize_lpc_codec(tau: int):
    """(encode, decode) near-lossless block codec: |x - rec| <= tau."""
    from lbdrn_msic_tpu_torch.codecs import lpc

    q = 2 * tau + 1

    def enc(block: np.ndarray) -> bytes:
        idx = ((block.astype(np.int32) + tau) // q).astype(np.uint16)
        return bytes([tau]) + lpc.encode(idx)

    def dec(data: bytes) -> np.ndarray:
        t = data[0]
        idx = lpc.decode(data[1:]).astype(np.int32)
        return np.clip(idx * (2 * t + 1), 0, 65535).astype(np.uint16)

    return enc, dec


def bdr_halfstep(images: dict, in_bits, out: str) -> str:
    """The BitMore/ABCD slot: test_bdr_halfstep.csv (needs OpenCV)."""
    from lbdrn_msic_tpu_torch.eval.bdr_anchors import evaluate_bdr_anchor

    path = os.path.join(out, "test_bdr_halfstep.csv")
    with tempfile.TemporaryDirectory() as work:
        evaluate_bdr_anchor(images, in_bits, path, halfstep_model, work)
    return path


def dlpr_substitute(images: dict, taus, out: str) -> str:
    """The DLPR slot: DLPR_substitute_rd.csv."""
    from lbdrn_msic_tpu_torch.codecs import lpc
    from lbdrn_msic_tpu_torch.eval.dlpr_anchor import sweep_rd

    return sweep_rd(
        images, taus, make_quantize_lpc_codec,
        extra_encode=lambda a: lpc.encode(a.astype(np.uint16)),
        extra_decode=lambda b: lpc.decode(b),
        out_csv=os.path.join(out, "DLPR_substitute_rd.csv"),
    )


def jxl_substitute(images: dict, out: str) -> str:
    """The JPEG-XL slot: JPEGXLsub_11rps.csv."""
    from lbdrn_msic_tpu_torch.eval.anchors import jxl_substitute_band_codec, sweep_to_csv

    path = os.path.join(out, "JPEGXLsub_11rps.csv")
    return sweep_to_csv(images, "JPEGXL", path, jxl_band_codec=jxl_substitute_band_codec())


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--out", type=str, default=OUT_DEFAULT)
    p.add_argument("--in-bits", type=int, nargs="*", default=list(range(8, 13)))
    p.add_argument("--taus", type=int, nargs="*", default=[0, 1, 2, 5, 10, 20])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; the run stops when CUDA is "
                        "absent unless --device cpu is given); the codecs run on "
                        "the host")
    args = p.parse_args(argv)

    from lbdrn_msic_tpu_torch.cli.common import device_from_args
    from lbdrn_msic_tpu_torch.scripts.suite import synth_suite

    device_from_args(args)
    os.makedirs(args.out, exist_ok=True)
    images = synth_suite(args.size, args.scenes, args.channels)
    print(f"wrote {bdr_halfstep(images, args.in_bits, args.out)}")
    print(f"wrote {dlpr_substitute(images, args.taus, args.out)}")
    print(f"wrote {jxl_substitute(images, args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
