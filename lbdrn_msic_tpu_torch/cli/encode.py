"""Encode CLI — drop-in analogue of the reference's encoder entry point.

Reference usage (README.md:18):
    python encode.py -K 5 -i data/sample.tif -D 2 -bc 64 -nl 2 -lr 0.001
        -bs 8192 -e 10 -sr 1 -prec 16 -o outputs

Here (on the card by default; `--device cpu` runs on the CPU):
    python -m lbdrn_msic_tpu_torch.cli.encode -K 5 -i data/sample.tif ... -o outputs

Data-parallel over N cards (rank 0 writes the outputs):
    torchrun --nproc-per-node N -m lbdrn_msic_tpu_torch.cli.encode --mesh dp=N ...

Flags, run-directory naming, resume markers and scrape-compatible log lines
are the JAX package's (its cli/encode.py), which follow the reference
(encode.py:210-224, :132-155, :283-284).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

from lbdrn_msic_tpu_torch.cli.common import (
    add_codec_args,
    config_from_args,
    device_from_args,
    is_writer,
    mesh_from_args,
)
from lbdrn_msic_tpu_torch.codec import encode_image
from lbdrn_msic_tpu_torch.io.tiff import read_tiff
from lbdrn_msic_tpu_torch.utils.logging import RunLogger, run_is_complete


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="LBDRN-MSIC encoder (PyTorch/CUDA)")
    p.add_argument("-i", "--path", type=str, required=True,
                   help="input multiband tif")
    p.add_argument("-o", "--output_dir", type=str, default="outputs")
    p.add_argument("--tensorboard", action="store_true",
                   help="emit train/loss and val curves as TensorBoard scalars "
                        "(reference encode.py:89-107 parity)")
    p.add_argument("--trace", type=str, default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the encode into DIR "
                        "(a Chrome trace: open with Perfetto)")
    add_codec_args(p, encode=True)
    args = p.parse_args(argv)
    device = device_from_args(args)
    mesh = mesh_from_args(args)
    writer = is_writer(mesh)

    cfg = config_from_args(args)
    if args.header_version == 0 and writer:
        # the v0 HEADER is byte-exact to the reference's layout but the
        # BODY is not reference-wire (docs/FORMAT.md "v0 body deviation
        # record"): reference tooling cannot decode this stream
        print(
            "[encode] warning: --header-version 0 writes the reference's "
            "header byte layout but NOT its body wire format (fpzip/JP2) — "
            "only this framework can decode the stream (docs/FORMAT.md).",
            file=sys.stderr,
        )
    stem = os.path.splitext(os.path.basename(args.path))[0]
    out_dir = os.path.join(args.output_dir, cfg.run_name(stem))
    if writer:
        os.makedirs(out_dir, exist_ok=True)
    bin_path = os.path.join(out_dir, f"{stem}.bin")

    if run_is_complete(out_dir, "encode.txt", "Time elapsed") and os.path.exists(bin_path):
        if writer:
            print("Bitstream already created!")
        return 0

    if writer:
        log = RunLogger(out_dir, "encode.txt")
    t0 = time.time()
    img = read_tiff(args.path)
    if writer:
        log.info(f"{args!r}")
    seed = None
    if args.randomness:
        seed = int.from_bytes(os.urandom(4), "big")
        if mesh is not None:  # every rank trains from rank 0's draw
            from lbdrn_msic_tpu_torch.parallel.distributed import collect_objects

            seed = collect_objects(seed, None)[0]
    from lbdrn_msic_tpu_torch.utils.build_log import BuildLog
    from lbdrn_msic_tpu_torch.utils.profiling import trace

    tr = trace(args.trace) if args.trace and writer else contextlib.nullcontext()
    bl = BuildLog() if args.compile_log else contextlib.nullcontext()
    with tr, bl:
        stream, stats = encode_image(img, cfg, seed=seed, device=device,
                                     header_version=args.header_version,
                                     collect_curves=args.tensorboard,
                                     bucket=args.bucket, mesh=mesh)
    if not writer:
        return 0
    if args.compile_log:
        print(bl.report(), file=sys.stderr)
        log.info(f"compile: {bl.total():.1f}s backend over {bl.built()} programs")
    write_encode_outputs(log, bin_path, stem, stream, stats, t0,
                         tensorboard=args.tensorboard,
                         out_dir=out_dir)
    log.close()
    return 0


def write_encode_outputs(log, bin_path, stem, stream, stats, t0,
                         tensorboard=False, out_dir=None):
    """Write the bitstream + the reference-format log lines for one run."""
    with open(bin_path, "wb") as f:
        f.write(stream)

    n_sub = stats.n_subpixels
    for i, t in enumerate(stats.tiles):
        log.info(f"tile {i}: best epoch: {t.best_epoch} (MSE: {t.best_mse:.5f})")
        log.info(f"nn: {t.nn_bytes} bytes, bpsp={t.nn_bytes * 8 / n_sub}")
        log.info(f"MSB: {t.base_bytes} bytes: bpsp={t.base_bytes * 8 / n_sub}")
        log.event(tile=i, nn_bytes=t.nn_bytes, base_bytes=t.base_bytes,
                  best_mse=t.best_mse, best_epoch=t.best_epoch,
                  train_time=t.train_time, base_time=t.base_time)
    if stats.phases:
        # host-side phase accounting — regressions show up per phase
        parts = " ".join(f"{k}={v:.3f}s" for k, v in sorted(stats.phases.items()))
        log.info(f"phases: {parts}")
        log.event(**{f"phase_{k}": round(v, 4) for k, v in stats.phases.items()})
    if tensorboard:
        from lbdrn_msic_tpu_torch.utils.tboard import (
            tensorboard_available,
            write_training_curves,
        )

        if tensorboard_available():
            for i, t in enumerate(stats.tiles):
                if t.step_losses is not None:
                    write_training_curves(out_dir, f"{stem}_t{i}", t.step_losses)
        else:
            log.info("tensorboard writer unavailable; skipping curves")
    log.info(f"Total size: {len(stream)} bytes, bpsp={len(stream) * 8 / n_sub}")
    log.info(f"Time elapsed: {time.time() - t0}")
    log.event(total_bytes=len(stream), bpsp=stats.bpsp, elapsed=stats.elapsed)


if __name__ == "__main__":
    sys.exit(main())
