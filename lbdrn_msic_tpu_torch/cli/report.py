"""BD report CLI — tables and RD plots from results CSVs.

The reporting layer of reference BD_metrics.py as a command: give it the
codec's results CSV and anchor CSVs (either produced here or the
reference's shipped SOTA_results files — same schema) and it emits
markdown BD-Rate/BD-PSNR tables and RD curve figures.
"""

from __future__ import annotations

import argparse
import os
import sys

from lbdrn_msic_tpu_torch.eval.reports import bd_table_markdown, rd_plot


def _parse_groups(specs, n_images):
    if not specs:
        return {"all": list(range(n_images))}
    groups = {}
    for s in specs:  # name=0-4 (inclusive ranges)
        name, rng = s.split("=")
        lo, hi = (int(x) for x in rng.split("-"))
        groups[name] = list(range(lo, hi + 1))
    return groups


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="LBDRN-MSIC BD reports (PyTorch/CUDA)")
    p.add_argument("-t", "--test-csv", required=True,
                   help="the codec's results CSV")
    p.add_argument("-a", "--anchors", nargs="+", required=True,
                   help="anchor CSVs as name=path")
    p.add_argument("-n", "--n-images", type=int, required=True)
    p.add_argument("-k", "--k-points", type=int, default=6)
    p.add_argument("--last", action="store_true",
                   help="use the LAST k rate rows (low-bitrate regime, "
                        "reference read_csv_lbr)")
    p.add_argument("-g", "--groups", nargs="*", default=None,
                   help="image groups as name=lo-hi (e.g. GF-2=0-4 WFI=5-8)")
    p.add_argument("--plot-dir", type=str, default=None,
                   help="also write an RD plot per image into this dir")
    p.add_argument("--latex", action="store_true",
                   help="emit a LaTeX tabular instead of markdown (the "
                        "reference's paper-table format, BD_metrics.py)")
    args = p.parse_args(argv)

    anchors = dict(a.split("=", 1) for a in args.anchors)
    groups = _parse_groups(args.groups, args.n_images)
    md = bd_table_markdown(
        anchors, args.test_csv, args.n_images, groups,
        k_points=args.k_points, last=args.last,
        fmt="latex" if args.latex else "markdown",
    )
    print(md)
    if args.plot_dir:
        os.makedirs(args.plot_dir, exist_ok=True)
        curves = {"this-work": args.test_csv, **anchors}
        for i in range(args.n_images):
            rd_plot(curves, i, os.path.join(args.plot_dir, f"rd_image{i}.png"),
                    args.n_images, args.k_points, last=args.last)
        print(f"RD plots -> {args.plot_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
