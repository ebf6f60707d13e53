"""Summarize CLI — scrape per-run decode logs into the canonical results CSV.

Mirrors reference results_summary.py:79-137: rows K{k-min}..K{k-max},
columns `K` then `{image}_{MSE,PSNR,bpsp,bits}` per image, written to
`results_r{sr}_bc{bc}_nl{nl}_D{D}_prec{prec}_lr{lr}_bs{bs}_e{e}.csv` in the
output dir.  `bits` is 8 * total bytes, matching the reference's scraper
(results_summary.py:29).
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys

from lbdrn_msic_tpu_torch.cli.common import add_codec_args, config_from_args
from lbdrn_msic_tpu_torch.utils.logging import scrape_log


def summarize(
    output_dir: str, stems: list[str], cfg_for_k, k_min: int, k_max: int
) -> str:
    cfg0 = cfg_for_k(k_min)
    t = cfg0.train
    csv_name = (
        f"results_r{cfg0.split_ratio}_bc{cfg0.model.base_channel}"
        f"_nl{cfg0.model.num_layers}_D{cfg0.features.D}_prec{cfg0.precision}"
        f"_lr{t.lr}_bs{t.batch_size}_e{t.epochs}"
    )
    # non-reference knobs get the same suffixes as run dirs so summaries
    # of differently-configured sweeps don't clobber each other
    if t.schedule != "step":
        csv_name += f"_{t.schedule}"
    if t.sample_granule != 1:
        csv_name += f"_g{t.sample_granule}"
    csv_name += ".csv"
    csv_path = os.path.join(output_dir, csv_name)
    metrics = ["MSE", "PSNR", "bpsp", "bits"]
    header = ["K"] + [f"{s}_{m}" for s in stems for m in metrics]
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for K in range(k_min, k_max + 1):
            row = [f"K{K}"]
            for stem in stems:
                run_dir = os.path.join(output_dir, cfg_for_k(K).run_name(stem))
                got = scrape_log(os.path.join(run_dir, "decode.txt"))
                row += [
                    got.get("mse"),
                    got.get("psnr"),
                    got.get("bpsp"),
                    8 * got["bytes"] if "bytes" in got else None,
                ]
            w.writerow(row)
    return csv_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="LBDRN-MSIC results summary (PyTorch/CUDA)")
    p.add_argument("-i", "--stems", nargs="+", required=True,
                   help="image stems (basename without extension)")
    p.add_argument("-o", "--output_dir", type=str, default="outputs")
    p.add_argument("--k-min", type=int, default=1)
    p.add_argument("--k-max", type=int, default=11)
    add_codec_args(p, encode=True)
    args = p.parse_args(argv)
    cfg = config_from_args(args)

    def cfg_for_k(K):
        return dataclasses.replace(cfg, K=K)

    path = summarize(args.output_dir, args.stems, cfg_for_k, args.k_min, args.k_max)
    print(f"All results have been written to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
