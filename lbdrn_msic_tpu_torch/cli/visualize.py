"""Visualization CLI — the reference's visu_image.py as a command.

Emits true-/false-color composites, MSB/LSB bit-plane views, and error-map
grids comparing one or more reconstructions against the original
(reference visu_image.py:11-383; figure helpers in utils/visualize.py).

    python -m lbdrn_msic_tpu_torch.cli.visualize -i scene.tif -o figs/ \
        --msb-lsb 5 --recon lbdrn=out/scene_recon.tif baseline=base.tif
"""

from __future__ import annotations

import argparse
import os
import sys

from lbdrn_msic_tpu_torch.io.tiff import read_tiff
from lbdrn_msic_tpu_torch.utils.visualize import (
    error_map_grid,
    msb_lsb_figure,
    save_composite,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="LBDRN-MSIC visualization (PyTorch/CUDA)")
    p.add_argument("-i", "--path", required=True, help="input multiband tif")
    p.add_argument("-o", "--out-dir", default="figures")
    p.add_argument("--bands", type=int, nargs=3, default=None,
                   help="composite band indices (default: true color 2,1,0 "
                        "and, with >= 4 bands, false color 3,2,1)")
    p.add_argument("--msb-lsb", type=int, default=None, metavar="K",
                   help="also emit the MSB/LSB bit-plane view at this K")
    p.add_argument("--band", type=int, default=0,
                   help="band for the MSB/LSB view / error maps")
    p.add_argument("--recon", nargs="*", default=[],
                   help="reconstructions as name=path; emits an error-map "
                        "grid vs the original")
    args = p.parse_args(argv)

    img = read_tiff(args.path)
    C = img.shape[0]
    os.makedirs(args.out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.path))[0]
    made = []

    if args.bands is not None:
        if not all(0 <= b < C for b in args.bands):
            raise SystemExit(
                f"--bands {args.bands} out of range for a {C}-band image"
            )
        made.append(save_composite(
            img, os.path.join(args.out_dir, f"{stem}_composite.png"),
            bands=tuple(args.bands),
        ))
    elif C >= 3:
        made.append(save_composite(
            img, os.path.join(args.out_dir, f"{stem}_true.png"), (2, 1, 0)
        ))
        if C >= 4:
            made.append(save_composite(
                img, os.path.join(args.out_dir, f"{stem}_false.png"), (3, 2, 1)
            ))
    else:  # 1-2 bands: grayscale of band 0
        made.append(save_composite(
            img, os.path.join(args.out_dir, f"{stem}_gray.png"), (0, 0, 0)
        ))
    if not (0 <= args.band < C):
        raise SystemExit(f"--band {args.band} out of range ({C} bands)")

    if args.msb_lsb is not None:
        made.append(msb_lsb_figure(
            img, args.msb_lsb,
            os.path.join(args.out_dir, f"{stem}_msb_lsb_K{args.msb_lsb}.png"),
            band=args.band,
        ))

    if args.recon:
        recons = {}
        for spec in args.recon:
            name, _, path = spec.partition("=")
            if not path:
                raise SystemExit(f"--recon wants name=path, got {spec!r}")
            recons[name] = read_tiff(path)
        made.append(error_map_grid(
            img, recons,
            os.path.join(args.out_dir, f"{stem}_error_maps.png"),
            band=args.band,
        ))

    for f in made:
        print(f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
