"""Anchor sweep CLI — the reference's SOTA.py main() as a command.

Runs the classical anchors over a set of images for K = k-min..k-max and
writes `{method}_{n}rps.csv` per method into the output dir (reference
SOTA.py:197-242 writes SOTA_results/{method}_11rps.csv).
"""

from __future__ import annotations

import argparse
import os
import sys

from lbdrn_msic_tpu_torch.eval import anchors
from lbdrn_msic_tpu_torch.io.tiff import read_tiff


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="LBDRN-MSIC anchor sweeps (PyTorch/CUDA)")
    p.add_argument("-i", "--paths", nargs="+", required=True)
    p.add_argument("-o", "--output_dir", type=str, default="SOTA_results")
    p.add_argument("-m", "--methods", nargs="+", default=["Baseline", "JPEG2000star", "JPEG2000"],
                   choices=list(anchors.METHODS))
    p.add_argument("--k-min", type=int, default=1)
    p.add_argument("--k-max", type=int, default=11)
    p.add_argument(
        "--jxl-substitute", action="store_true",
        help="run the JPEGXL slot with the in-repo substitute band codec "
        "when cjxl/djxl are absent (results labeled JPEGXLsub)",
    )
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    images = {}
    for path in args.paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        images[stem] = read_tiff(path)

    n_pts = args.k_max - args.k_min + 1
    for method in args.methods:
        label, jxl_codec = method, None
        if method == "JPEGXL" and not anchors.jpegxl_available():
            if not args.jxl_substitute:
                print(f"[anchors] skipping {method}: cjxl/djxl not on PATH "
                      f"(pass --jxl-substitute for the in-repo stand-in)")
                continue
            label, jxl_codec = "JPEGXLsub", anchors.jxl_substitute_band_codec()
        out_csv = os.path.join(args.output_dir, f"{label}_{n_pts}rps.csv")
        print(f"[anchors] {label} -> {out_csv}")
        anchors.sweep_to_csv(images, method, out_csv, args.k_min, args.k_max,
                             jxl_band_codec=jxl_codec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
