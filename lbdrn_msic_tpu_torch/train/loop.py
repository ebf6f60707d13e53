"""The per-image overfit loop, single device, "cached" staging.

Faithful semantics (RD parity with the reference at matched settings):
- per-epoch shuffle = fresh random permutation of all g-pixel granules;
  the last partial batch is kept and masked (DataLoader drop_last=False),
- loss = MSE over the batch (reference LBDRNloss.py:4-11),
- Adam(lr) with torch defaults + StepLR(step_size=max(1, epochs//3),
  gamma=0.1) (reference encode.py:84-85), or the cosine schedule,
- every ``val_every`` epochs, full-image MSE decides a strict-improvement
  best-params checkpoint (reference encode.py:96-117); with epochs == 1 the
  final weights are taken directly (reference encode.py:100-103).

Every step is one row gather from the feature cache and one call of the
fused step (`ops/fused_step.py`: the CUDA kernel on the card) or, with
`use_fused=False`, of the exact autograd step.  The loop never syncs with
the device inside an epoch: per-step losses land in a preallocated device
tensor, and the best-params rule reads one scalar per evaluated epoch.

Randomness (init params, epoch permutations) is drawn from a CPU
`torch.Generator`, so CPU and card runs see the same numbers; tests inject
the JAX package's init params and permutations instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from lbdrn_msic_tpu_torch import resolve_device
from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.features.engine import (
    build_feature_cache,
    build_label_matrix,
    feature_block_rows,
)
from lbdrn_msic_tpu_torch.models.siren import (
    SirenParams,
    forward,
    init_params as siren_init,
    pad_dim,
)
from lbdrn_msic_tpu_torch.ops.fused_step import fused_train_step, reference_train_step


@dataclasses.dataclass
class FitResult:
    params: SirenParams  # best-MSE params (the bitstream payload)
    best_mse: float
    best_epoch: int  # 1-indexed, -1 if never evaluated
    final_params: SirenParams
    epoch_losses: torch.Tensor  # (epochs,) mean train loss per epoch
    step_losses: torch.Tensor  # (epochs, steps_per_epoch) per-iteration loss


def make_lr_schedule(tspec: TrainSpec, steps_per_epoch: int) -> Callable[[int], float]:
    """step (0-indexed) -> learning rate, computed in float32 on the host."""
    f32 = np.float32
    if tspec.schedule == "cosine":
        total = max(1, tspec.epochs * steps_per_epoch)

        def schedule(step: int) -> float:
            c = np.cos(f32(np.pi) * f32(step) / f32(total), dtype=f32)
            return float(f32(tspec.lr * 0.5) * (f32(1.0) + c))

        return schedule

    step_size = tspec.lr_step_size()

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        return float(f32(tspec.lr) * f32(tspec.lr_gamma) ** f32(epoch // step_size))

    return schedule


def dataset_mse(params: SirenParams, x_cache: torch.Tensor, labels: torch.Tensor,
                mspec: ModelSpec, H: int, W: int, block_rows: int,
                fast_act: bool = False) -> torch.Tensor:
    """Full-image MSE over contiguous row blocks of the feature cache.

    x_cache: (>= H*W, padded_in) f32 model inputs; labels: (>= H*W, C) f32
    scaled labels.  Blocks start at min(b*R, H-R); rows a clamped block
    re-reads are masked, as in the JAX package.  Returns a 0-d f32 tensor."""
    C = labels.shape[1]
    R = block_rows
    sse = torch.zeros((), dtype=torch.float32, device=x_cache.device)
    for b in range(-(-H // R)):
        r0 = min(b * R, H - R)
        x = x_cache[r0 * W : (r0 + R) * W]
        pred = forward(params, x, mspec, fast_act=fast_act)
        y = labels[r0 * W : (r0 + R) * W]
        skip = b * R - r0  # leading rows already counted by block b-1
        err = (pred - y) ** 2
        sse = sse + err[skip * W :].sum()
    return sse / (H * W * C)


def _granule_batches(perm: torch.Tensor, n_g: int, n: int, g: int, steps: int):
    """(steps, bs//g) padded permutation -> (clipped granule ids, (steps, bs)
    f32 masks): padding ids n_g and pixels past n are masked."""
    gvalid = perm < n_g
    gi = torch.clamp(perm, max=n_g - 1)
    if g == 1:
        return gi, gvalid.to(torch.float32)
    pix = gi[:, :, None] * g + torch.arange(g, device=perm.device)
    valid = gvalid[:, :, None] & (pix < n)
    return gi, valid.reshape(steps, -1).to(torch.float32)


def fit(
    plane: torch.Tensor,
    plane_scale: torch.Tensor,
    labels: torch.Tensor,
    label_scale: float,
    generator: Optional[torch.Generator],
    fspec: FeatureSpec,
    mspec: ModelSpec,
    tspec: TrainSpec,
    H: int,
    W: int,
    C: int,
    use_fused: Optional[bool] = None,
    init: Optional[SirenParams] = None,
    perms: Optional[Sequence[np.ndarray]] = None,
    device=None,
) -> FitResult:
    """Overfit one network to one image tile, batches gathered from the
    f32 feature cache ("cached" staging).

    plane: (C, H+2D, W+2D) int32 padded base plane; plane_scale: 0-d 1/max.
    labels: (C, H, W) integer LSB plane; label_scale: 1/(2^K-1) as float32.
    `generator`: CPU generator for the init params and the per-epoch
    permutations; `init` / `perms` (one permutation of the granule ids per
    epoch) replace the draws when given.  `use_fused` (default: on CUDA)
    trains with the fused step, else with the exact autograd step.
    """
    dev = resolve_device(device)
    if use_fused is None:
        use_fused = dev.type == "cuda"
    step_fn = fused_train_step if use_fused else reference_train_step
    with torch.no_grad():
        plane, plane_scale, labels = plane.to(dev), plane_scale.to(dev), labels.to(dev)
        dim_in = fspec.feature_dim(C)
        padded_in = pad_dim(dim_in)
        n = H * W
        bs = min(tspec.batch_size, n)
        g = tspec.sample_granule
        if g > 1 and bs % g:
            g = 1
        n_g = -(-n // g)
        bpg = bs // g
        steps = -(-n_g // bpg)
        block_rows = feature_block_rows(H, W)

        x_cache = build_feature_cache(plane, plane_scale, fspec, H, W, padded_in, g=g)
        y_all = build_label_matrix(labels, n_g * g).to(torch.float32) * np.float32(label_scale)
        xg = x_cache.view(n_g, g * padded_in)
        yg = y_all.view(n_g, g * C)
        xbuf = torch.empty((bpg, g * padded_in), dtype=torch.float32, device=dev)
        ybuf = torch.empty((bpg, g * C), dtype=torch.float32, device=dev)

        if init is None:
            init = siren_init(generator, dim_in, C, mspec, pad_input_to=padded_in)
        params = init.map(lambda t: t.to(dev, torch.float32).clone())
        m_state = params.map(torch.zeros_like)
        v_state = params.map(torch.zeros_like)
        schedule = make_lr_schedule(tspec, steps)

        step_losses = torch.zeros((tspec.epochs, steps), dtype=torch.float32, device=dev)
        best = params.map(torch.zeros_like)
        best_mse, best_epoch = np.float32(1e6), -1
        count = 0
        for epoch in range(tspec.epochs):
            if perms is not None:
                perm = torch.from_numpy(np.array(perms[epoch], dtype=np.int64))
            else:
                perm = torch.randperm(n_g, generator=generator)
            perm = torch.cat([perm, torch.full((steps * bpg - n_g,), n_g, dtype=torch.int64)])
            gi, masks = _granule_batches(perm.view(steps, bpg).to(dev), n_g, n, g, steps)
            for s in range(steps):
                torch.index_select(xg, 0, gi[s], out=xbuf)
                torch.index_select(yg, 0, gi[s], out=ybuf)
                step_fn(params, m_state, v_state, xbuf.view(bs, padded_in),
                        ybuf.view(bs, C), masks[s], schedule(count), count + 1,
                        mspec, C, loss_out=step_losses[epoch, s])
                count += 1

            if tspec.epochs == 1:
                best = params.map(torch.clone)
                best_mse, best_epoch = float(step_losses[0].mean()), 1
            elif (epoch + 1) % min(tspec.val_every, tspec.epochs) == 0:
                mse = float(dataset_mse(params, x_cache, y_all, mspec, H, W,
                                        block_rows, fast_act=use_fused))
                if mse < best_mse:  # strict improvement, one sync per epoch
                    best = params.map(torch.clone)
                    best_mse, best_epoch = mse, epoch + 1
        return FitResult(
            params=best,
            best_mse=float(best_mse),
            best_epoch=int(best_epoch),
            final_params=params,
            epoch_losses=step_losses.mean(dim=1),
            step_losses=step_losses,
        )
