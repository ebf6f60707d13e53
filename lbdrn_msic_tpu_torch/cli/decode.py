"""Decode CLI — analogue of the reference's decoder entry point.

Reference usage (README.md:23):
    python decode.py -i OUT/.../sample.bin -org data/sample.tif

Here (on the card by default; `--device cpu` runs on the CPU):
    python -m lbdrn_msic_tpu_torch.cli.decode -i OUT/.../sample.bin -org data/sample.tif

In row bands over N cards (rank 0 writes the outputs):
    torchrun --nproc-per-node N -m lbdrn_msic_tpu_torch.cli.decode --mesh dp=N ...

Flags and log lines (MSE/PSNR/Total size/bpsp/Time elapsed) are the JAX
package's, scrape-compatible with the reference's results_summary.py
regexes (decode.py:210-224).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from lbdrn_msic_tpu_torch.cli.common import (
    add_codec_args,
    device_from_args,
    is_writer,
    mesh_from_args,
)
from lbdrn_msic_tpu_torch.codec import decode_stream
from lbdrn_msic_tpu_torch.eval.metrics import PSNR_PEAK
from lbdrn_msic_tpu_torch.io.tiff import read_tiff, write_tiff
from lbdrn_msic_tpu_torch.utils.logging import RunLogger, run_is_complete


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="LBDRN-MSIC decoder (PyTorch/CUDA)")
    p.add_argument("-i", "--bin_path", type=str, required=True)
    p.add_argument("-org", "--org_path", type=str, default=None,
                   help="original image for PSNR report")
    p.add_argument("--keep-recon", action="store_true",
                   help="keep the reconstruction tif even when -org is given "
                        "(the reference deletes it, decode.py:223)")
    add_codec_args(p, encode=False)
    args = p.parse_args(argv)
    device = device_from_args(args)
    mesh = mesh_from_args(args)
    writer = is_writer(mesh)

    dirname = os.path.dirname(args.bin_path) or "."
    if run_is_complete(dirname, "decode.txt", "bpsp"):
        if writer:
            print("Bitstream already decoded!")
        return 0

    if writer:
        log = RunLogger(dirname, "decode.txt")
        log.info(f"Binstream: {args.bin_path}")
    t0 = time.time()
    with open(args.bin_path, "rb") as f:
        stream = f.read()
    from lbdrn_msic_tpu_torch.utils.build_log import BuildLog

    bl = BuildLog() if args.compile_log else contextlib.nullcontext()
    with bl:
        rec, dstats = decode_stream(stream, device=device, mesh=mesh)
    if not writer:
        return 0
    if args.compile_log:
        print(bl.report(), file=sys.stderr)
    write_decode_outputs(
        log, args.bin_path, rec, dstats, t0,
        org_path=args.org_path, keep_recon=args.keep_recon,
    )
    log.close()
    return 0


def write_decode_outputs(
    log, bin_path, rec, dstats, t_start, org_path=None, keep_recon=False
):
    """Reconstruction tif + scrape-compatible decode.txt metric lines
    (reference decode.py:203-224 format)."""
    dirname = os.path.dirname(bin_path) or "."
    stem = os.path.splitext(os.path.basename(bin_path))[0]
    recon_path = os.path.join(dirname, f"{stem}_recon.tif")
    write_tiff(recon_path, rec)
    log.info(f"Recon: {recon_path}")
    log.info(f"Time elapsed: {time.time() - t_start}")

    if org_path is not None:
        org = read_tiff(org_path)
        mse = float(np.mean((org.astype(np.float32) - rec.astype(np.float32)) ** 2))
        log.info(f"MSE: {mse}")
        psnr = float(10 * np.log10(PSNR_PEAK**2 / mse)) if mse > 0 else float("inf")
        log.info(f"PSNR: {psnr}")
        n_bytes = os.path.getsize(bin_path)
        n_sub = int(np.prod(org.shape))
        log.info(f"Total size: {n_bytes} bytes, bpsp={n_bytes * 8 / n_sub}")
        log.event(mse=mse, psnr=psnr, bytes=n_bytes, bpsp=n_bytes * 8 / n_sub,
                  elapsed=dstats.elapsed)
        if not keep_recon:
            os.remove(recon_path)


if __name__ == "__main__":
    sys.exit(main())
