"""Scale sanity check: larger scenes and band counts on the card.

Validates memory behavior (tap-matrix staging, fallbacks), throughput
scaling, and correctness at shapes closer to real Gaofen scenes
(6000^2 x 8 bands) than the unit tests use.

Usage: python -m lbdrn_msic_tpu_torch.scripts.scale_check [--sizes 2048 4096]
       [--channels 4 8] [--flagship] [--dataset N] [--device cuda|cpu]

`--device` defaults to cuda; the run stops without CUDA unless given
`--device cpu`.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", type=int, nargs="+", default=[2048, 4096])
    p.add_argument("--channels", type=int, nargs="+", default=[4, 8])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--granule", type=int, default=8)
    p.add_argument("--K", type=int, nargs="+", default=[5])
    p.add_argument(
        "--flagship", action="store_true",
        help="run the real Gaofen scene shapes instead of --sizes/--channels: "
             "GF-6 WFI 6000x6000x8 and GF-2 7815x7605x4",
    )
    p.add_argument("--base-codec", default="jp2", choices=["jp2", "lpc"])
    p.add_argument("--decode-focus", action="store_true",
                   help="--dataset mode: measure cross-image encode + "
                        "pipelined decode only (skip encode-mode A/B)")
    p.add_argument(
        "--dataset", type=int, metavar="N", default=0,
        help="instead of per-image runs: encode an N-image x len(--K)-point "
             "dataset three ways (per-job pipeline / per-image experts / "
             "cross-image experts) and report aggregate Mpx/s",
    )
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; the run stops when CUDA is "
                        "absent unless --device cpu is given)")
    args = p.parse_args(argv)

    from lbdrn_msic_tpu_torch.cli.common import device_from_args
    from lbdrn_msic_tpu_torch.codec import decode_stream, encode_image, pick_staging
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.eval.metrics import psnr
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene

    device = device_from_args(args)
    if args.dataset:
        return _dataset_check(args, device)

    if args.flagship:
        shapes = [(6000, 6000, 8), (7815, 7605, 4)]
    else:
        shapes = [(s, s, c) for c in args.channels for s in args.sizes]

    tspec = TrainSpec(epochs=args.epochs, sample_granule=args.granule)
    for (h, w, c) in shapes:
        img = synth_scene(h, w, channels=c, effective_bits=12, seed=7)
        for K in args.K:
            cfg = CodecConfig(K=K, train=tspec, base_codec=args.base_codec)
            staging, _ = pick_staging(
                h, w, c, int(img.max()) >> K, cfg.features, tspec
            )
            t0 = time.time()
            stream, stats = encode_image(img, cfg, device=device)
            t_cold = time.time() - t0
            t0 = time.time()
            stream, stats = encode_image(img, cfg, device=device)
            t_enc = time.time() - t0
            t0 = time.time()
            rec, _ = decode_stream(stream, device=device)
            t_dec = time.time() - t0
            ok = np.array_equal(rec >> K, img >> K)
            print(
                f"{h}x{w}x{c} K={K} [{staging}]: encode {t_enc:.2f}s "
                f"({h*w/1e6/t_enc:.2f} Mpx/s) decode {t_dec:.2f}s "
                f"({h*w/1e6/t_dec:.2f} Mpx/s) | "
                f"PSNR {psnr(img, rec):.2f} bpsp {stats.bpsp:.3f} | "
                f"msb-lossless={ok} (cold {t_cold:.1f}s, "
                f"train {stats.tiles[0].train_time:.2f}s "
                f"base {stats.tiles[0].base_time:.2f}s)",
                flush=True,
            )
            if not ok:
                raise RuntimeError(f"{h}x{w}x{c} K={K}: MSBs not lossless")
    return 0


def _dataset_check(args, device) -> int:
    """Aggregate throughput of an N-image x R-rate-point dataset encode,
    comparing the three sweep modes (reference workload: run.sh:29-40)."""
    from lbdrn_msic_tpu_torch.codec import (
        decode_pipelined_iter,
        decode_stream,
        encode_dataset,
        encode_pipelined,
        encode_rate_points,
    )
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.eval.metrics import psnr
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene

    h = w = args.sizes[0]
    c = args.channels[0]
    tspec = TrainSpec(epochs=args.epochs, sample_granule=args.granule)
    imgs = [
        synth_scene(h, w, channels=c, effective_bits=12, seed=100 + i)
        for i in range(args.dataset)
    ]
    cfgs = [CodecConfig(K=K, train=tspec, base_codec=args.base_codec) for K in args.K]
    jobs = [(im, cfg) for im in imgs for cfg in cfgs]
    total_mpx = len(jobs) * h * w / 1e6

    def run(label, fn):
        fn()  # warm-up: loads the kernels
        best = float("inf")
        for _ in range(2):
            t0 = time.time()
            results = fn()
            best = min(best, time.time() - t0)
        print(
            f"dataset {args.dataset}x{len(cfgs)} @ {h}x{w}x{c} [{label}]: "
            f"{best:.2f}s = {total_mpx / best:.2f} Mpx/s aggregate "
            f"({best / len(jobs):.2f} s/job)",
            flush=True,
        )
        return results, best

    res_x, t_x = run("cross-image experts", lambda: encode_dataset(jobs, device=device))

    # the decode half: aggregate pipelined decode over the cross-image
    # streams, decode-ahead depth 2 (the codec default)
    streams = [s for s, _ in res_x]
    list(decode_pipelined_iter(iter(streams), device=device))  # warm-up
    best_dec = float("inf")
    for _ in range(2):
        t0 = time.time()
        decs = [r for r, _ in decode_pipelined_iter(iter(streams), device=device)]
        best_dec = min(best_dec, time.time() - t0)
    print(
        f"dataset {args.dataset}x{len(cfgs)} @ {h}x{w}x{c} "
        f"[pipelined decode ahead=2]: {best_dec:.2f}s = "
        f"{total_mpx / best_dec:.2f} Mpx/s aggregate "
        f"({best_dec / len(jobs):.2f} s/job)",
        flush=True,
    )
    for (im, cfg), rec in zip(jobs, decs):
        if not np.array_equal(rec >> cfg.K, im >> cfg.K):
            raise RuntimeError(f"pipelined decode K={cfg.K}: MSBs not lossless")
    if args.decode_focus:
        print("streams verified (decode focus: encode-mode A/B skipped)",
              flush=True)
        return 0

    _, t_p = run("per-job pipeline", lambda: encode_pipelined(jobs, device=device))

    def per_image():
        out = []
        for im in imgs:
            out += encode_rate_points(im, cfgs, device=device)
        return out

    _, t_i = run("per-image experts", per_image)

    for (im, cfg), (stream, _) in zip(jobs, res_x):
        rec, _ = decode_stream(stream, device=device)
        if not np.array_equal(rec >> cfg.K, im >> cfg.K):
            raise RuntimeError(f"decode K={cfg.K}: MSBs not lossless")
        solo_p = psnr(im, rec)
        if not solo_p > 20:
            raise RuntimeError(f"decode K={cfg.K}: PSNR {solo_p} dB")
    print(
        f"speedup vs pipeline {t_p / t_x:.2f}x, vs per-image experts "
        f"{t_i / t_x:.2f}x; streams verified", flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
