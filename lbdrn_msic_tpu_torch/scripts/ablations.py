"""The reference's ablation matrix on a synthetic suite, the counterpart of
scripts/ablations.py.

The reference's README drives run.sh over four experiment groups
(reference README.md:28-62; tables from BD_metrics.py:111-520):

  1. feature set        - rel-colors D1/D2/D3, +coords, coords-only,
                          coords+embedding, abs-colors D2/D0
  2. (bc, nl) network   - (64,2) anchor, (128,1), (128,2), (256,2)
  3. lr / bs / epochs   - lr 1e-2/1e-4, bs 4096/2048, e 1/5/15
  4. split_ratio        - sr 2, sr 3

Every variant is swept over K rate points on synthetic Gaofen-like scenes
(`encode_rate_points`: the six K train together as experts, K2 on the
card, where the configs allow it; one `encode_image` a K, K1, for the
coordinate-only features and split_ratio > 1), one results CSV a variant,
then the BD-Rate / BD-PSNR tables against each group's anchor
(`eval/reports.ablation_table_markdown`) in <out>/ABLATIONS.md.

    python -m lbdrn_msic_tpu_torch.scripts.ablations [--size 256]
        [--scenes 2] [--k-min 1] [--k-max 6]
        [--out out/validation/ablations]
        [--groups feature network training split] [--device cuda|cpu]

`--device` defaults to cuda; the run stops without CUDA unless given
`--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from lbdrn_msic_tpu_torch.scripts.suite import OUT_DEFAULT

GROUPS = ("feature", "network", "training", "split")


def variant_matrix():
    """{group: (anchor name, {variant name: CodecConfig kwargs})},
    reference README.md:28-62."""
    from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec, TrainSpec

    F = FeatureSpec
    feature = {
        "rel-colors-D2": dict(features=F()),  # anchor
        "rel-colors-D1": dict(features=F(D=1)),
        "rel-colors-D3": dict(features=F(D=3)),
        "coords-rel-colors-D2": dict(features=F(use_coords=True)),
        "coords": dict(features=F(use_coords=True, use_colors=False)),
        "coords-embedding": dict(
            features=F(use_coords=True, embedding=True, use_colors=False)
        ),
        "abs-colors-D2": dict(features=F(relative=False)),
        "abs-colors-D0": dict(features=F(relative=False, D=0)),
    }
    network = {
        "bc64-nl2": dict(model=ModelSpec()),  # anchor
        "bc128-nl1": dict(model=ModelSpec(base_channel=128, num_layers=1)),
        "bc128-nl2": dict(model=ModelSpec(base_channel=128)),
        "bc256-nl2": dict(model=ModelSpec(base_channel=256)),
    }
    T = TrainSpec
    training = {
        "lr1e-3-bs8192-e10": dict(train=T()),  # anchor
        "lr1e-2": dict(train=T(lr=1e-2)),
        "lr1e-4": dict(train=T(lr=1e-4)),
        "bs4096": dict(train=T(batch_size=4096)),
        "bs2048": dict(train=T(batch_size=2048)),
        "e1": dict(train=T(epochs=1)),
        "e5": dict(train=T(epochs=5)),
        "e15": dict(train=T(epochs=15)),
    }
    split = {
        "sr1": dict(split_ratio=1),  # anchor
        "sr2": dict(split_ratio=2),
        "sr3": dict(split_ratio=3),
    }
    return {
        "feature": ("rel-colors-D2", feature),
        "network": ("bc64-nl2", network),
        "training": ("lr1e-3-bs8192-e10", training),
        "split": ("sr1", split),
    }


def variant_config(kwargs: dict, granule: int, base_codec: str = "jp2"):
    """A variant's CodecConfig at `granule` (the JAX script's rule: the
    variant's TrainSpec, or the default one, with sample_granule set)."""
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec

    cfg = CodecConfig(**kwargs, base_codec=base_codec)
    train = cfg.train if "train" in kwargs else TrainSpec()
    return dataclasses.replace(cfg, train=dataclasses.replace(train, sample_granule=granule))


def sweep_variant_csv(images, base_cfg, ks, granule, path, device=None):
    """Sweep one config over K rate points for every scene (one
    `encode_rate_points` a scene, every stream decoded); write the
    canonical CSV (rows K, columns {image}_{MSE,PSNR,bpsp,bits}).  Returns
    (path, jobs whose MSBs decode exactly)."""
    from lbdrn_msic_tpu_torch.codec import encode_rate_points
    from lbdrn_msic_tpu_torch.scripts.suite import rd_point, write_rd_csv

    names = list(images)
    rd, n_exact = {}, 0
    for n in names:
        cfgs = [dataclasses.replace(base_cfg, K=K) for K in ks]
        for K, (stream, _) in zip(ks, encode_rate_points(images[n], cfgs, device=device)):
            rd[(K, n)], exact = rd_point(images[n], stream, K, device)
            n_exact += exact
    return write_rd_csv(path, names, ks, rd), n_exact


def run_group(images, group: str, ks, granule: int, out: str, device, resume: bool = False,
              base_codec: str = "jp2"):
    """Every variant of `group`, then its BD table against the group's
    anchor.  Returns (the markdown section, {variant: CSV path})."""
    from lbdrn_msic_tpu_torch.eval.reports import ablation_table_markdown

    anchor_name, variants = variant_matrix()[group]
    os.makedirs(out, exist_ok=True)
    csvs = {}
    for name, kwargs in variants.items():
        path = os.path.join(out, f"{group}_{name}.csv")
        if resume and os.path.exists(path):
            print(f"[{group}] {name}: reusing {path}", flush=True)
        else:
            t0 = time.time()
            sweep_variant_csv(images, variant_config(kwargs, granule, base_codec), ks, granule,
                              path, device)
            print(f"[{group}] {name}: {time.time() - t0:.1f}s -> {path}", flush=True)
        csvs[name] = path
    others = {n: p for n, p in csvs.items() if n != anchor_name}
    table = ablation_table_markdown(others, csvs[anchor_name], n_images=len(images),
                                    groups={"all": list(range(len(images)))},
                                    k_points=len(ks))
    return [f"## {group} (anchor: {anchor_name})\n", table, ""], csvs


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--k-min", type=int, default=1)
    p.add_argument("--k-max", type=int, default=6)
    p.add_argument("--granule", type=int, default=8)
    p.add_argument("--base-codec", choices=["jp2", "lpc"], default="jp2")
    p.add_argument("--out", type=str, default=os.path.join(OUT_DEFAULT, "ablations"))
    p.add_argument("--groups", nargs="*", default=list(GROUPS), choices=GROUPS)
    p.add_argument(
        "--resume", action="store_true",
        help="reuse existing per-variant CSVs instead of re-sweeping them",
    )
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
    md = [
        "# Ablation matrix (synthetic suite)",
        "",
        f"{args.scenes} synthetic {args.size}x{args.size}x{args.channels} scenes, "
        f"K={args.k_min}..{args.k_max}, sample_granule={args.granule}.  "
        "Negative BD-Rate = variant beats the anchor.  Mirrors the reference's "
        "experiment groups (reference README.md:28-62, BD_metrics.py:111-520) "
        "on synthetic stand-ins for the LFS-absent Gaofen scenes.",
        "",
        f"Caveat: at {args.size}^2 px the network weights are a far larger "
        "bitstream fraction than on real 36-Mpx Gaofen scenes, so variants "
        "that grow the model (bc/nl, D3, split_ratio>1 — one network per "
        "tile) look worse here than the reference reports at full scale; "
        "the directional ordering within each group is what this matrix "
        "validates.  Re-run with --size at the real scene sizes when the "
        "dataset is available.",
        "",
    ]
    for group in args.groups:
        md += run_group(images, group, ks, args.granule, args.out, device, args.resume,
                        args.base_codec)[0]
    out_md = os.path.join(args.out, "ABLATIONS.md")
    with open(out_md, "w") as f:
        f.write("\n".join(md))
    print(f"wrote {out_md}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
