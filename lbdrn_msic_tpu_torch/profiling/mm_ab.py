"""A/B the fused step's product precision on the card.

The counterpart of scripts/profiling/mm_ab.py.  Times the production `fit`
(bench config: 2048^2 x 4, K=5, bs=8192, e=10, g=8, cached staging, one K1
launch a step) with mm_dtype None (f32 products) against "bfloat16" (bf16
operands, exact products, f32 sums), and reports each run's converged best
full-image MSE, so the RD cost of bf16 shows next to its speed.

    python -m lbdrn_msic_tpu_torch.profiling.mm_ab
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from lbdrn_msic_tpu_torch import resolve_device

MM_DTYPES = (None, "bfloat16")


def ab(rounds: int = 3, device=None) -> dict:
    """`rounds` fits of the bench config at each mm_dtype, interleaved
    (None, bf16, None, ...), after one warm fit of each.  Returns
    {mm_dtype: {"seconds": [...], "best_mse": x, "best_epoch": n}}; the
    best MSE is the same every round (the fit is deterministic)."""
    from lbdrn_msic_tpu_torch.codec import _prepare_tile, tile_generator
    from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec, TrainSpec
    from lbdrn_msic_tpu_torch.features.engine import lsb_scale
    from lbdrn_msic_tpu_torch.train.loop import fit
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene
    from lbdrn_msic_tpu_torch.utils.transfer import put_image

    dev = resolve_device(device)
    H = W = 2048
    C, K = 4, 5
    fspec, mspec, tspec = FeatureSpec(), ModelSpec(), TrainSpec(sample_granule=8)
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=42)
    plane, plane_scale, labels = _prepare_tile(put_image(img, dev), K, fspec.D)
    label_scale = float(np.float32(lsb_scale(K)))
    out = {mmd: {"seconds": []} for mmd in MM_DTYPES}
    for rnd in range(rounds + 1):
        for mmd in MM_DTYPES:
            torch.cuda.synchronize()
            t0 = time.time()
            r = fit(plane, plane_scale, labels, label_scale, tile_generator(tspec.seed, 0),
                    fspec, mspec, tspec, H, W, C, mm_dtype=mmd, device=dev)
            torch.cuda.synchronize()
            if rnd:
                out[mmd]["seconds"].append(time.time() - t0)
            out[mmd].update(best_mse=r.best_mse, best_epoch=r.best_epoch)
    return out


def main(argv=None) -> int:
    resolve_device(None)
    for mmd, row in ab().items():
        mse = row["best_mse"]
        print(f"mm_dtype={mmd!s:>9}: fit {min(row['seconds']) * 1e3:7.1f} ms  "
              f"best_mse {mse:.6e} ({10 * np.log10(1.0 / mse):.2f} dB on unit scale)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
