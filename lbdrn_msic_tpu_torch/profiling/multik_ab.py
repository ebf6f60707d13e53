"""A/B the fused multi-step chunk size on the card, the counterpart of
scripts/profiling/multik_ab.py.

Times `fit` at the bench config (2048^2 x 4, K=5, g=8, e=10, "cached"
staging, val_every=10: one eval a fit) at multi_k in {0, 4, 16, 64}: one warm round,
then interleaved timed rounds, every sample printed.  Spread between
rounds is the host's noise; an ordering that holds in every round is
signal.  multi_k=0 is one K1 launch a step; k > 0 is one K3 launch a
chunk of k steps, bit for bit the same fit.

    python -m lbdrn_msic_tpu_torch.profiling.multik_ab [--device cuda|cpu]

`--device` defaults to cuda; the run stops without CUDA unless given
`--device cpu`, where the plain step runs and multi_k changes nothing.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from lbdrn_msic_tpu_torch import resolve_device

VARIANTS = (0, 4, 16, 64)


def bench_fit(device=None, size: int = 2048):
    """(fit_k, steps an epoch): fit_k(k) runs `fit` on the bench scene
    (size x size) at multi_k=k and returns its FitResult."""
    from lbdrn_msic_tpu_torch.codec import _prepare_tile, tile_generator
    from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec, TrainSpec
    from lbdrn_msic_tpu_torch.features.engine import lsb_scale
    from lbdrn_msic_tpu_torch.train.loop import _batch_geometry, fit
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene
    from lbdrn_msic_tpu_torch.utils.transfer import put_image

    dev = resolve_device(device)
    H = W = size
    C, K = 4, 5
    fspec, mspec = FeatureSpec(), ModelSpec()
    tspec = TrainSpec(sample_granule=8, val_every=10)
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=42)
    plane, plane_scale, labels = _prepare_tile(put_image(img, dev), K, fspec.D)
    label_scale = float(np.float32(lsb_scale(K)))

    def fit_k(k):
        return fit(plane, plane_scale, labels, label_scale, tile_generator(tspec.seed, 0),
                   fspec, mspec, tspec, H, W, C, staging="cached", multi_k=k, device=dev)

    return fit_k, _batch_geometry(tspec, H, W).steps


def ab(fit_k, variants=VARIANTS, rounds: int = 2, device=None) -> dict:
    """One warm round, then `rounds` timed rounds of fit_k over `variants`,
    interleaved; prints every timed sample.  Returns {k: {"seconds": [...],
    "best_mse": x}}."""
    sync = torch.cuda.synchronize if resolve_device(device).type == "cuda" else (lambda: None)
    out = {k: {"seconds": []} for k in variants}
    for rnd in range(rounds + 1):
        for k in variants:
            sync()
            t0 = time.time()
            r = fit_k(k)
            sync()
            secs = time.time() - t0
            out[k]["best_mse"] = r.best_mse
            if rnd:
                out[k]["seconds"].append(secs)
                print(f"round {rnd - 1} multi_k={k:>2}: {secs * 1e3:7.1f} ms", flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; the run stops when CUDA is "
                        "absent unless --device cpu is given)")
    args = p.parse_args(argv)

    from lbdrn_msic_tpu_torch.cli.common import device_from_args

    device = device_from_args(args)
    ab(bench_fit(device)[0], device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
