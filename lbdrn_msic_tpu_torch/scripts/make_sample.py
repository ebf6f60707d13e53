"""Write a sample scene: a stand-in for the reference's README smoke input
(the 2048x2048 GF-2 crop, reference visu_image.py:38), the counterpart of
scripts/make_sample.py.

A statistically similar 2048x2048x4-band 12-bit synthetic scene (seed 42,
the bench scene), written as a TIFF with the port's writer.  Host only.

    python -m lbdrn_msic_tpu_torch.scripts.make_sample [--size 2048]
        [--out out/data/sample.tif] [--device cuda|cpu]

`--device` defaults to cuda, as every entry point of the port: the run
stops without CUDA unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=2048)
    p.add_argument("--out", type=str, default="out/data/sample.tif")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; the run stops when CUDA is "
                        "absent unless --device cpu is given)")
    args = p.parse_args(argv)

    from lbdrn_msic_tpu_torch.cli.common import device_from_args
    from lbdrn_msic_tpu_torch.io.tiff import write_tiff
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene

    device_from_args(args)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    img = synth_scene(args.size, args.size, channels=4, effective_bits=12, seed=42)
    write_tiff(args.out, img)
    print(f"wrote {args.out}: {img.shape} uint16 (12-bit effective)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
