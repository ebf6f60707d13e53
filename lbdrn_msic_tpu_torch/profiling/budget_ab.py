"""A/B two trees' memory plans on the card at the Gaofen shapes.

Runs, in one process on one tree of the port, the codec calls whose plan
the staging budget decides, each with the K1 / K2 launch counts zeroed
before it and the allocator's cache emptied, and prints one JSON line:

- `encode_image` of the GF-2 scene (7605x7815x4, 12-bit, seed 42) at K=3;
- `encode_rate_points` of it at K 3..6;
- `encode_dataset(bucket=True)` of the flagship scenes GF2_D, WFI_A and
  PMS_A at K 3..6, one call a scene, as `scripts.flagship_workload` runs
  them.

Each row: seconds (host clock, `torch.cuda.synchronize()` on both sides),
staging, chunks, launches, peak device memory allocated and reserved, and
the streams' sha256.  Two trees compare inside one call, run in turn
(parent, change, change, parent):

    python lbdrn_msic_tpu_torch/profiling/budget_ab.py --root DIR \\
        --cache DIR --epochs 1 [--out FILE]

`--root` is the checkout whose `lbdrn_msic_tpu_torch` is imported (default:
the one holding this file); the script uses only entry points every slice
of the port has had since the dataset encode.  `--cache` keeps the
synthetic scenes as .npy files, so that only the first run makes them.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

# the flagship scenes the A/B encodes (scripts/flagship_workload.py SCENES)
FLAGSHIP = (("GF2_D", 4, 7605, 7815), ("WFI_A", 8, 6000, 6000), ("PMS_A", 4, 6000, 6000))
KS = (3, 4, 5, 6)


def _scene(cache, name, make):
    """The scene `name` from `cache`, else make() saved there."""
    import numpy as np

    path = os.path.join(cache, f"{name}.npy")
    if os.path.exists(path):
        return np.load(path)
    img = make()
    np.save(path + ".part.npy", img)
    os.replace(path + ".part.npy", path)
    return img


def run(epochs: int, cache: str) -> dict:
    import torch

    from lbdrn_msic_tpu_torch import codec
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.ops.fused_step import fused_expert_step, fused_train_step
    from lbdrn_msic_tpu_torch.scripts.flagship_workload import scene_seed
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene

    os.makedirs(cache, exist_ok=True)
    train = TrainSpec(sample_granule=8, epochs=epochs)
    cfg = lambda K: CodecConfig(K=K, base_codec="lpc", train=train)
    sha = lambda b: hashlib.sha256(b).hexdigest()

    def measured(fn):
        fused_train_step.launches = fused_expert_step.launches = 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, {"seconds": time.time() - t0,
                     "launches": [fused_train_step.launches, fused_expert_step.launches],
                     "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9}

    # load the libraries and warm the allocator off the clock
    codec.encode_image(synth_scene(256, 256, channels=4, effective_bits=12, seed=0), cfg(5))
    gf2 = _scene(cache, "gf2_seed42", lambda: synth_scene(
        7605, 7815, channels=4, effective_bits=12, seed=42, fast=True))
    out = {"budget_bytes": codec.STAGE_BUDGET_BYTES, "epochs": epochs}

    (stream, stats), row = measured(lambda: codec.encode_image(gf2, cfg(3)))
    row.update(staging=stats.tiles[0].staging, sha256=sha(stream))
    out["gf2_encode_k3"] = row

    res, row = measured(lambda: codec.encode_rate_points(gf2, [cfg(K) for K in KS]))
    row.update(staging=res[0][1].tiles[0].staging, sha256=[sha(s) for s, _ in res])
    out["gf2_sweep"] = row
    del gf2, res

    scenes = []
    for stem, C, H, W in FLAGSHIP:
        img = _scene(cache, stem, lambda: synth_scene(
            H, W, channels=C, effective_bits=12, seed=scene_seed(stem), fast=True))
        res, row = measured(lambda: codec.encode_dataset([(img, cfg(K)) for K in KS],
                                                          bucket=True))
        plan = res[0][1].plan
        row.update(scene=stem, staging=plan.staging, chunks=[len(c) for c in plan.chunks],
                   budget=plan.budget, sha256=[sha(s) for s, _ in res])
        scenes.append(row)
    out["flagship"] = scenes
    out["flagship_seconds"] = sum(r["seconds"] for r in scenes)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="the checkout whose lbdrn_msic_tpu_torch to import")
    ap.add_argument("--cache", required=True, help="where the synthetic scenes are kept")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.abspath(args.root or os.path.join(here, "..", ".."))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("budget_ab: CUDA is not available", file=sys.stderr)
        return 1
    line = {"root": args.root or ".", **run(args.epochs, args.cache)}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
