"""Regenerate every validation study of the port with one command, the
counterpart of scripts/repro_all.py.

Runs, in order, each study as `python -m lbdrn_msic_tpu_torch.<module>` in
a subprocess of its own (a crash in one study does not take the rest
down), each on the same `--device`, writing under <out> =
out/validation (git-ignored):

  rd             RD validation + classical anchors + BD   -> <out>/*.csv
  anchors        substitute-driven anchor harnesses       -> <out>/*.csv
  recipe         training-recipe study                    -> <out>/RECIPE.md
  ablations      ablation matrix, 256^2                   -> <out>/ablations/
  ablations1024  network and split groups at 1024^2       -> <out>/ablations_1024/
  ablations2048  network group at 2048^2, one scene       -> <out>/ablations_2048/
  scale          scale_check at the Gaofen shapes          (stdout)
  dataset        scale_check's cross-image dataset A/B     (stdout)
  bench          the headline benchmark (scripts.bench)    (stdout JSON line)

scripts/r4_measurements.sh is the ablations1024, ablations2048 and scale
steps.

    python -m lbdrn_msic_tpu_torch.scripts.repro_all [--only rd,recipe]
        [--skip-flagship] [--device cuda|cpu]

`--skip-flagship` runs scale_check at its default sizes instead of the
Gaofen shapes.  `--device` defaults to cuda; the run stops without CUDA
unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from lbdrn_msic_tpu_torch.scripts.suite import OUT_DEFAULT

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PKG = "lbdrn_msic_tpu_torch"


def steps(out: str) -> dict:
    """{step: (module, arguments)} writing under `out`."""
    abl = f"{PKG}.scripts.ablations"
    scale = f"{PKG}.scripts.scale_check"
    return {
        "rd": (f"{PKG}.scripts.rd_validation", ["--out", out]),
        "anchors": (f"{PKG}.scripts.substitute_anchors", ["--out", out]),
        "recipe": (f"{PKG}.scripts.recipe_study", ["--out", out]),
        "ablations": (abl, ["--out", os.path.join(out, "ablations")]),
        "ablations1024": (abl, ["--size", "1024", "--scenes", "2", "--groups", "network",
                                "split", "--out", os.path.join(out, "ablations_1024")]),
        "ablations2048": (abl, ["--size", "2048", "--scenes", "1", "--groups", "network",
                                "--out", os.path.join(out, "ablations_2048")]),
        "scale": (scale, ["--flagship"]),
        "dataset": (scale, ["--dataset", "4", "--sizes", "2048", "--channels", "4",
                            "--K", "3", "4", "5", "6"]),
        "bench": (f"{PKG}.scripts.bench", []),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--only", type=str, default=None,
                   help="comma-separated subset of the steps")
    p.add_argument("--skip-flagship", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of every step (default cuda; the run stops "
                        "when CUDA is absent unless --device cpu is given)")
    args = p.parse_args(argv)

    from lbdrn_msic_tpu_torch.cli.common import device_from_args

    device_from_args(args)
    table = steps(os.path.join(REPO, OUT_DEFAULT))
    wanted = list(table) if not args.only else args.only.split(",")
    unknown = [w for w in wanted if w not in table]
    if unknown:
        raise SystemExit(f"unknown steps {unknown}; have {list(table)}")
    print(f"steps: {','.join(wanted)}", flush=True)

    failures = []
    for name in wanted:
        module, extra = table[name]
        if name == "scale" and args.skip_flagship:
            extra = []  # default sizes instead of --flagship
        cmd = [sys.executable, "-m", module, *extra, "--device", args.device]
        print(f"\n=== [{name}] {' '.join(cmd)}", flush=True)
        t0 = time.time()
        rc = subprocess.run(cmd, cwd=REPO).returncode
        print(f"=== [{name}] rc={rc} in {time.time() - t0:.0f}s", flush=True)
        if rc != 0:
            failures.append(name)
    if failures:
        print(f"FAILED steps: {failures}", file=sys.stderr)
        return 1
    print("\nall validation artifacts regenerated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
