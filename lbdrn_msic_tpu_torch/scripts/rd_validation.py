"""End-to-end RD validation on a synthetic Gaofen-like suite, the
counterpart of scripts/rd_validation.py.

The reference's headline experiment (the run.sh sweep, the SOTA anchors,
the BD report) without the LFS-absent Gaofen data: a small multi-scene
suite, the LBDRN codec and the classical anchors swept over K rate
points, the canonical CSVs, and the BD-Rate / BD-PSNR of the codec
against each anchor.  The codec should land clearly negative in BD-Rate
against Baseline (the reference reports about -15..-20 % on real Gaofen
scenes, SURVEY §6).

    python -m lbdrn_msic_tpu_torch.scripts.rd_validation [--size 512]
        [--scenes 3] [--k-min 1] [--k-max 6] [--out out/validation]
        [--device cuda|cpu]

The parts: `lbdrn_sweep` (every (K, scene) job through `encode_pipelined`,
K1 on the card, each stream decoded through `decode_stream`),
`anchor_sweep` (Baseline, JPEG2000star, JPEG2000; host codecs that need
OpenCV) and `bd_lines`; `main` composes them.  `--device` defaults to
cuda; the run stops without CUDA unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from lbdrn_msic_tpu_torch.scripts.suite import OUT_DEFAULT

ANCHORS = ("Baseline", "JPEG2000star", "JPEG2000")


def lbdrn_sweep(images: dict, ks, epochs: int, granule: int, path: str, device,
                base_codec: str = "jp2", schedule: str = "step", tag: str = "lbdrn") -> dict:
    """Every (K, scene) job in one `encode_pipelined` call, each stream
    decoded; writes the results CSV at `path` and logs each job under
    `tag`.  Returns {"csv", "seconds" (the encode), "jobs", "msb_exact"
    (jobs whose MSBs decode exactly), "rd": {(K, name): [MSE, PSNR, bpsp,
    bits]}}."""
    from lbdrn_msic_tpu_torch.codec import encode_pipelined
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.scripts.suite import rd_point, write_rd_csv

    names = list(images)
    jobs, tags = [], []
    for K in ks:
        cfg = CodecConfig(K=K, base_codec=base_codec, train=TrainSpec(
            epochs=epochs, sample_granule=granule, schedule=schedule))
        for n in names:
            jobs.append((images[n], cfg))
            tags.append((K, n))
    t0 = time.time()
    encoded = encode_pipelined(jobs, device=device)
    secs = time.time() - t0
    print(f"[{tag}] pipelined encode of {len(jobs)} jobs: {secs:.1f}s", flush=True)
    rd, n_exact = {}, 0
    for (K, n), (stream, _) in zip(tags, encoded):
        rd[(K, n)], exact = rd_point(images[n], stream, K, device)
        n_exact += exact
        print(f"[{tag}] {n} K={K}: {rd[(K, n)][1]:.2f} dB {rd[(K, n)][2]:.3f} bpsp",
              flush=True)
    return {"csv": write_rd_csv(path, names, ks, rd), "seconds": secs, "jobs": len(jobs),
            "msb_exact": n_exact, "rd": rd}


def anchor_sweep(images: dict, k_min: int, k_max: int, out: str, methods=ANCHORS) -> dict:
    """{method: CSV path} of each classical anchor over K (OpenCV)."""
    from lbdrn_msic_tpu_torch.eval import anchors

    paths = {}
    for method in methods:
        path = os.path.join(out, f"{method}_{k_max - k_min + 1}rps.csv")
        print(f"[anchors] {method}", flush=True)
        anchors.sweep_to_csv(images, method, path, k_min, k_max)
        paths[method] = path
    return paths


def bd_lines(anchor_csvs: dict, lbdrn_csv: str, n_images: int, k_points: int):
    """(the report's lines, {method: BDResult}): BD of the codec against
    each anchor over every scene."""
    from lbdrn_msic_tpu_torch.eval.reports import bd_report

    lines, results = [], {}
    for method, path in anchor_csvs.items():
        r = results[method] = bd_report(path, lbdrn_csv, n_images=n_images, k_points=k_points)
        lines.append(f"vs {method:13s}: BD-Rate {r.group_rate['all']:+.3f} %  "
                     f"BD-PSNR {r.group_psnr['all']:+.3f} dB")
    return lines, results


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--scenes", type=int, default=3)
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--k-min", type=int, default=1)
    p.add_argument("--k-max", type=int, default=6)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--granule", type=int, default=8)
    p.add_argument("--base-codec", choices=["jp2", "lpc"], default="jp2",
                   help="the LBDRN streams' base codec (the anchors' is jp2)")
    p.add_argument("--out", type=str, default=OUT_DEFAULT)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; the run stops when CUDA is "
                        "absent unless --device cpu is given)")
    args = p.parse_args(argv)

    from lbdrn_msic_tpu_torch.cli.common import device_from_args
    from lbdrn_msic_tpu_torch.scripts.suite import synth_suite

    device = device_from_args(args)
    os.makedirs(args.out, exist_ok=True)
    images = synth_suite(args.size, args.scenes, args.channels)
    ks = list(range(args.k_min, args.k_max + 1))
    sweep = lbdrn_sweep(images, ks, args.epochs, args.granule,
                        os.path.join(args.out, "lbdrn_results.csv"), device, args.base_codec)
    anchor_csvs = anchor_sweep(images, args.k_min, args.k_max, args.out)
    print("\n== BD of LBDRN-MSIC-TPU vs anchors "
          f"({args.scenes} synthetic scenes, K={args.k_min}..{args.k_max}) ==")
    for line in bd_lines(anchor_csvs, sweep["csv"], len(images), len(ks))[0]:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
