"""Training-recipe study, the counterpart of scripts/recipe_study.py.

The reference's recipe (Adam + StepLR(gamma=0.1 every e//3), 10 epochs,
reference encode.py:84-85) drops the LR to 1e-6 by epoch 9: the last third
of the run barely learns.  This study sweeps recipe variants (a cosine
schedule, more epochs) over a synthetic Gaofen-like suite, writes one RD
CSV per recipe, and reports each variant's BD-Rate / BD-PSNR against the
reference recipe beside its measured encode time a job.  The CSVs go to
<out>/recipe/ and the table to <out>/RECIPE.md.

    python -m lbdrn_msic_tpu_torch.scripts.recipe_study [--size 512]
        [--scenes 3] [--k-min 1] [--k-max 6] [--out out/validation]
        [--device cuda|cpu]

Each recipe is one `encode_pipelined` call over every (K, scene) job (K1
on the card).  `--device` defaults to cuda; the run stops without CUDA
unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import sys

from lbdrn_msic_tpu_torch.scripts.suite import OUT_DEFAULT

RECIPES = [
    # (tag, schedule, epochs)
    ("ref_e10", "step", 10),  # the reference's default recipe
    ("cos_e10", "cosine", 10),
    ("cos_e20", "cosine", 20),
    ("cos_e40", "cosine", 40),
]


def run_recipe(images: dict, ks, tag: str, schedule: str, epochs: int, granule: int,
               outdir: str, device, base_codec: str = "jp2") -> dict:
    """One recipe over the suite: `rd_validation.lbdrn_sweep`'s result for
    <outdir>/<tag>.csv, with "s_per_job"."""
    from lbdrn_msic_tpu_torch.scripts.rd_validation import lbdrn_sweep

    r = lbdrn_sweep(images, ks, epochs, granule, os.path.join(outdir, f"{tag}.csv"), device,
                    base_codec, schedule, tag)
    r["s_per_job"] = r["seconds"] / r["jobs"]
    print(f"[{tag}] {r['jobs']} jobs in {r['seconds']:.1f}s ({r['s_per_job']:.2f}s/job)",
          flush=True)
    return r


def recipe_table(runs: dict, n_images: int, k_points: int, intro: str):
    """(RECIPE.md's lines, {tag: BDResult against the first recipe}) from
    {tag: run_recipe result}, in RECIPES order."""
    from lbdrn_msic_tpu_torch.eval.reports import bd_report

    ref_tag = RECIPES[0][0]
    lines = [
        "# Training-recipe study",
        "",
        "BD-Rate / BD-PSNR of each recipe against the reference recipe",
        intro,
        "",
        "| recipe | schedule | epochs | BD-Rate vs ref | BD-PSNR | s/job |",
        "|---|---|---|---|---|---|",
    ]
    bd = {}
    for tag, schedule, epochs in RECIPES:
        s_job = runs[tag]["s_per_job"]
        if tag == ref_tag:
            lines.append(f"| {tag} | {schedule} | {epochs} | — | — | {s_job:.2f} |")
            continue
        r = bd[tag] = bd_report(runs[ref_tag]["csv"], runs[tag]["csv"], n_images=n_images,
                                k_points=k_points)
        print(f"{tag}: BD-Rate {r.group_rate['all']:+.3f} %  "
              f"BD-PSNR {r.group_psnr['all']:+.3f} dB  {s_job:.2f}s/job", flush=True)
        lines.append(f"| {tag} | {schedule} | {epochs} | {r.group_rate['all']:+.3f} % | "
                     f"{r.group_psnr['all']:+.3f} dB | {s_job:.2f} |")
    return lines, bd


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--scenes", type=int, default=3)
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--k-min", type=int, default=1)
    p.add_argument("--k-max", type=int, default=6)
    p.add_argument("--granule", type=int, default=8)
    p.add_argument("--base-codec", choices=["jp2", "lpc"], default="jp2")
    p.add_argument("--out", type=str, default=OUT_DEFAULT)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; the run stops when CUDA is "
                        "absent unless --device cpu is given)")
    args = p.parse_args(argv)

    from lbdrn_msic_tpu_torch.cli.common import device_from_args
    from lbdrn_msic_tpu_torch.scripts.suite import device_label, synth_suite

    device = device_from_args(args)
    outdir = os.path.join(args.out, "recipe")
    os.makedirs(outdir, exist_ok=True)
    images = synth_suite(args.size, args.scenes, args.channels)
    ks = list(range(args.k_min, args.k_max + 1))
    runs = {tag: run_recipe(images, ks, tag, schedule, epochs, args.granule, outdir, device,
                            args.base_codec)
            for tag, schedule, epochs in RECIPES}
    intro = (
        f"(StepLR, 10 epochs — reference encode.py:84-85), measured on {args.scenes} "
        f"synthetic {args.size}x{args.size}x{args.channels} scenes, "
        f"K={args.k_min}..{args.k_max}, sample_granule={args.granule}, base codec "
        f"{args.base_codec}.  Encode time is per (image, K) job, pipelined, on "
        f"{device_label(device)}.  Reproduce: `python -m "
        "lbdrn_msic_tpu_torch.scripts.recipe_study`."
    )
    lines, _ = recipe_table(runs, len(images), len(ks), intro)
    md = os.path.join(args.out, "RECIPE.md")
    with open(md, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {md}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
