"""Where does the single-image encode's train time go?

The counterpart of scripts/profiling/step_prof.py.  Times, on the card, the
bench configuration (2048^2 x 4, K=5, bc=64, nl=2, bs=8192, e=10, g=8,
cached staging):

  fit_e10_v1      the production `fit` (512 steps x 10 epochs + 10 evals)
  fit_e10_v10     the same with one eval (epoch 10 only) -> eval marginal cost
  build_cache     feature-cache staging cost (part of dispatch)
  steps512_fixed  512 fused steps (K1) on ONE prebuilt batch (no gather)
  steps512_gather 512 fused steps with the cached-row gather per step
  eval_once       one full-image `dataset_mse` over the feature cache

Each phase is timed on the host clock around work that ends in a device
synchronize, best of three (build_cache: two).

    python -m lbdrn_msic_tpu_torch.profiling.step_prof
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from lbdrn_msic_tpu_torch import resolve_device
from lbdrn_msic_tpu_torch.profiling import timed


def main(argv=None) -> int:
    from lbdrn_msic_tpu_torch.codec import _prepare_tile
    from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec, TrainSpec
    from lbdrn_msic_tpu_torch.features.engine import (
        build_feature_cache, build_label_matrix, feature_block_rows, lsb_scale)
    from lbdrn_msic_tpu_torch.models.siren import init_params, pad_dim
    from lbdrn_msic_tpu_torch.ops.fused_step import fused_train_step
    from lbdrn_msic_tpu_torch.train.loop import _granule_batches, dataset_mse, fit
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene
    from lbdrn_msic_tpu_torch.utils.transfer import put_image

    dev = resolve_device(None)
    H = W = 2048
    C, K, g, bs = 4, 5, 8, 8192
    fspec, mspec = FeatureSpec(), ModelSpec()
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=42)
    plane, plane_scale, labels = _prepare_tile(put_image(img, dev), K, fspec.D)
    label_scale = float(np.float32(lsb_scale(K)))
    dim_in = fspec.feature_dim(C)
    padded_in = pad_dim(dim_in)

    t_full = {}
    for ve, tag in ((1, "fit_e10_v1"), (10, "fit_e10_v10")):
        tspec = TrainSpec(sample_granule=g, val_every=ve)
        t_full[tag] = timed(tag, lambda ts=tspec: fit(
            plane, plane_scale, labels, label_scale, torch.Generator().manual_seed(0),
            fspec, mspec, ts, H, W, C))

    timed("build_cache",
          lambda: build_feature_cache(plane, plane_scale, fspec, H, W, padded_in, g=g), n=2)
    x_cache = build_feature_cache(plane, plane_scale, fspec, H, W, padded_in, g=g)
    n = H * W
    n_g = -(-n // g)
    y_all = build_label_matrix(labels, n_g * g).to(torch.float32) * np.float32(label_scale)
    xg, yg = x_cache.view(n_g, g * padded_in), y_all.view(n_g, g * C)

    gen = torch.Generator().manual_seed(1)
    params = init_params(gen, dim_in, C, mspec, pad_input_to=padded_in, device=dev)
    xb = (torch.rand((bs, padded_in), generator=gen) * 2 - 1).to(dev)
    yb = torch.rand((bs, C), generator=gen).to(dev)
    maskb = torch.ones(bs, device=dev)
    losses = torch.empty(512, device=dev)

    def steps_fixed():
        p, m, v = params.map(torch.clone), params.map(torch.zeros_like), params.map(torch.zeros_like)
        for i in range(512):
            fused_train_step(p, m, v, xb, yb, maskb, 1e-3, i + 1, mspec, C, loss_out=losses[i])
        return losses.sum()

    timed("steps512_fixed", steps_fixed)

    bpg = bs // g
    perm = torch.randperm(n_g, generator=torch.Generator().manual_seed(3))[: 512 * bpg]
    gi, masks = _granule_batches(perm.view(512, bpg).to(dev), n_g, n, g, 512)
    xbuf = torch.empty((bpg, g * padded_in), device=dev)
    ybuf = torch.empty((bpg, g * C), device=dev)

    def steps_gather():
        p, m, v = params.map(torch.clone), params.map(torch.zeros_like), params.map(torch.zeros_like)
        for i in range(512):
            torch.index_select(xg, 0, gi[i], out=xbuf)
            torch.index_select(yg, 0, gi[i], out=ybuf)
            fused_train_step(p, m, v, xbuf.view(bs, padded_in), ybuf.view(bs, C), masks[i],
                             1e-3, i + 1, mspec, C, loss_out=losses[i])
        return losses.sum()

    timed("steps512_gather", steps_gather)
    block_rows = feature_block_rows(H, W)
    timed("eval_once", lambda: dataset_mse(params, x_cache, y_all, mspec, H, W, block_rows))
    print(f"derived: eval marginal ~ "
          f"{(t_full['fit_e10_v1'] - t_full['fit_e10_v10']) / 9 * 1e3:.1f} ms/eval over 9 "
          f"extra evals", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
