"""The per-image overfit loop (`fit`, in any of the four staging modes of
features/engine.py) and the rate-sweep loop that trains one network per
rate point K together (`fit_rate_experts`, "full" or "banded" staging).

Faithful semantics (RD parity with the reference at matched settings):
- per-epoch shuffle = fresh random permutation of all g-pixel granules;
  the last partial batch is kept and masked (DataLoader drop_last=False),
- loss = MSE over the batch (reference LBDRNloss.py:4-11),
- Adam(lr) with torch defaults + StepLR(step_size=max(1, epochs//3),
  gamma=0.1) (reference encode.py:84-85), or the cosine schedule,
- every ``val_every`` epochs, full-image MSE decides a strict-improvement
  best-params checkpoint (reference encode.py:96-117); with epochs == 1 the
  final weights are taken directly (reference encode.py:100-103).

Both loops run each epoch in chunks of steps (`chunk_steps`: as many as
MULTI_STEP_BYTES of staged batches hold) and build a chunk's batches in
one pass, by the staging mode (`fit`) or from every expert's taps
(`fit_rate_experts`).  Then every step of `fit` makes one call of the
fused step (`ops/fused_step.py`: kernel K1 on the card) or, with
`use_fused=False`, of the exact autograd step, on its views of the
chunk's buffers; every step of `fit_rate_experts` makes one call of the
expert step (kernel K2) for all experts.  The batches are those a step
would build alone, in the same order.  With `multi_k`, the fused loops
make one multi-step call a chunk of k steps instead (K3, or K4 for
experts), the same function as k single steps and, on the card,
bit-identical to them.  Each epoch's permutation and masks are drawn once
the epoch before has issued its steps, while the card works through them
(the draws in the same order as one an epoch at its start).
`mm_dtype="bfloat16"` (opt-in, as in the JAX package) rounds the operands
of the fused steps' products to bf16; the eval stays f32.  Neither loop
syncs with the device inside an epoch: per-step losses land in a
preallocated device tensor, and the best-params rule reads one scalar per
evaluated epoch (per expert).

Randomness (init params, epoch permutations) is drawn from a CPU
`torch.Generator`, so CPU and card runs see the same numbers; tests inject
the JAX package's init params and permutations instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from lbdrn_msic_tpu_torch import resolve_device
from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.features.engine import (
    _coord_features,
    banded_geometry,
    banded_window_features,
    build_banded_labels,
    build_feature_cache,
    build_granule_labels,
    build_label_matrix,
    build_row_taps,
    build_tap_matrix,
    feature_block_rows,
    gather_features,
    lsb_scale,
    pad_plane,
    row_block_features,
    row_taps_dtype,
    split_msb_lsb,
    staged_features,
    tap_matrix_dtype,
)
from lbdrn_msic_tpu_torch.models.siren import (
    SirenParams,
    forward,
    init_params as siren_init,
    pad_dim,
    unstack_params,
)
from lbdrn_msic_tpu_torch.ops.fused_step import (
    _apply_adam,
    fused_expert_multi_step,
    fused_eval_sse,
    fused_eval_sse_plain,
    fused_expert_step,
    fused_multi_step,
    fused_train_step,
    reference_train_step,
)
from lbdrn_msic_tpu_torch.parallel.distributed import collect
from lbdrn_msic_tpu_torch.utils.profiling import NoTimer, PhaseTimer

# the staged f32 batches of one chunk of steps stay under this many bytes
# (`chunk_steps`): the per-step path's and the opt-in `multi_k` path's
MULTI_STEP_BYTES = 512 << 20


@dataclasses.dataclass
class FitResult:
    """One network's fit; from `fit_rate_experts`, every field carries a
    leading expert axis (best_mse and best_epoch are lists of E)."""

    params: SirenParams  # best-MSE params (the bitstream payload)
    best_mse: float
    best_epoch: int  # 1-indexed, -1 if never evaluated
    final_params: SirenParams
    epoch_losses: torch.Tensor  # (epochs,) mean train loss per epoch
    step_losses: torch.Tensor  # (epochs, steps_per_epoch) per-iteration loss
    staging: str = "cached"  # the mode the batches were built in
    staged_bytes: int = 0  # device bytes of its staging buffers (all experts')


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

    @functools.lru_cache(maxsize=None)
    def decayed(n: int) -> float:  # after n decays: one value for step_size epochs
        return float(f32(tspec.lr) * f32(tspec.lr_gamma) ** f32(n))

    def schedule(step: int) -> float:
        return decayed(step // steps_per_epoch // step_size)

    return schedule


def blocks_mse(params: SirenParams, x_rows: Callable, y_rows: Callable,
               mspec: ModelSpec, H: int, W: int, C: int, block_rows: int,
               fast_act: bool = False, hw: Optional[Tuple[int, int]] = None,
               dp_group=None, dim_in: Optional[int] = None) -> torch.Tensor:
    """Full-image MSE over row blocks of R = `block_rows` image rows.

    x_rows(r0) / y_rows(r0): the (R*W, padded_in) f32 model inputs and the
    (R*W, C) f32 scaled labels of rows r0..r0+R.  Blocks start at
    min(b*R, H-R); rows a clamped block re-reads are masked, as in the JAX
    package.  `hw`: the real (height, width) of a bucket-padded tile (H, W
    the bucket's): pixels at row >= hw[0] or column >= hw[1] are left out
    and the SSE is normalized by the real pixel count, in float32 as the
    JAX package forms it.  `dp_group`: the blocks are round-robined over
    the group's ranks and their SSE summed over it (the JAX package's
    `dataset_mse` under data parallelism), so every rank gets the same
    MSE.  Each block's forward, error and sum are one call: with
    `fast_act`, `fused_eval_sse` (kernel K6 on the card; its plain version
    on the CPU), given `dim_in`, the live input width, when known; else
    `fused_eval_sse_plain` with the exact sine.  Returns a 0-d f32 tensor."""
    R = block_rows
    sse = torch.zeros((), dtype=torch.float32, device=params.weights[0].device)
    first, stride = 0, 1
    if dp_group is not None:
        first, stride = dist.get_rank(dp_group), dist.get_world_size(dp_group)
    for b in range(first, -(-H // R), stride):
        if hw is not None and b * R >= hw[0]:
            break  # every later row is padding
        r0 = min(b * R, H - R)
        skip = b * R - r0  # leading rows already counted by block b-1
        rows, cols = (R, W) if hw is None else (min(R, hw[0] - r0), hw[1])
        if fast_act:
            fused_eval_sse(params, x_rows(r0), y_rows(r0), mspec, W, skip, rows, cols,
                           out=sse, dim_in=dim_in)
        else:  # the exact eval (torch.sin) in plain torch ops, on any device
            fused_eval_sse_plain(params, x_rows(r0), y_rows(r0), mspec, W, skip, rows, cols,
                                 out=sse, fast_act=False)
    if dp_group is not None:
        sse = collect(sse, dp_group)
    if hw is None:
        return sse / (H * W * C)
    return sse / float(np.float32(hw[0]) * np.float32(hw[1]) * np.float32(C))


def dataset_mse(params: SirenParams, x_cache: torch.Tensor, labels: torch.Tensor,
                mspec: ModelSpec, H: int, W: int, block_rows: int,
                fast_act: bool = False) -> torch.Tensor:
    """Full-image MSE over contiguous row blocks of the feature cache.

    x_cache: (>= H*W, padded_in) f32 model inputs; labels: (>= H*W, C) f32
    scaled labels.  Returns a 0-d f32 tensor."""
    n = block_rows * W
    return blocks_mse(params, lambda r0: x_cache[r0 * W : r0 * W + n],
                      lambda r0: labels[r0 * W : r0 * W + n],
                      mspec, H, W, labels.shape[1], block_rows, fast_act)


class Geometry(NamedTuple):
    """A fit's batch geometry: batch size, sampling granule, granules,
    granules per image row ("banded"'s W-padded grid; 0 for flat grids,
    whose granules are runs of g pixels in row-major order), granules per
    batch, steps per epoch."""

    bs: int
    g: int
    n_g: int
    ng_row: int
    bpg: int
    steps: int


def _batch_geometry(tspec: TrainSpec, H: int, W: int, staging: str = "cached",
                    dp: int = 1) -> Geometry:
    """The JAX package's batch geometry (train/loop.py:266-314): the
    granule is 1 for "gather" and where it does not divide the batch;
    "banded" counts H * ceil(W / g) granules, which never cross a row.
    With `dp` > 1 ranks the batch rounds down to a multiple of dp (at least
    dp) and the granule must also divide each rank's bs / dp slice."""
    n = H * W
    bs = min(tspec.batch_size, n)
    if dp > 1:
        bs = max(dp, bs - bs % dp)
    g = tspec.sample_granule if staging != "gather" else 1
    if g > 1 and (bs % g or bs // dp % g):
        g = 1
    ng_row = banded_geometry(W, g)[1] if staging == "banded" else 0
    n_g = H * ng_row if ng_row else -(-n // g)
    bpg = bs // g
    return Geometry(bs, g, n_g, ng_row, bpg, -(-n_g // bpg))


def chunk_steps(E: int, bs: int, padded_in: int, steps: int) -> int:
    """Steps whose staged (E, bs, padded_in) f32 batches fit in
    MULTI_STEP_BYTES together, at least 1 and at most one epoch's."""
    return max(1, min(MULTI_STEP_BYTES // (E * bs * padded_in * 4), steps))


def multi_step_k(multi_k: Optional[int], use_fused: bool, E: int, bs: int,
                 padded_in: int, steps: int, per_expert_masks: bool = False) -> int:
    """Steps per multi-step call (0: one step per call), by the JAX
    package's rule (train/loop.py:333-339 for `fit`, E = 1; :739-752 for
    `fit_rate_experts`): 0 unless `use_fused`, or with per-expert masks
    (the kernel shares one mask per step); else `multi_k` capped by
    `chunk_steps`; below 2, 0.  The JAX rule also needs the batch to fit
    one TPU VMEM tile (`pick_tile(bs) == bs`); the card's kernel tiles any
    batch, so that gate is dropped."""
    if not use_fused or not multi_k or per_expert_masks:
        return 0
    k = min(multi_k, chunk_steps(E, bs, padded_in, steps))
    return k if k >= 2 else 0


def _chunks(steps: int, k: int):
    """An epoch's (first step, length) chunks: floor(steps / k) of k steps,
    then the remainder."""
    return [(s0, min(k, steps - s0)) for s0 in range(0, steps, k)]


def _epoch_batches(epoch: int, perms, generator, geo: Geometry, H: int, W: int,
                   dev: torch.device, hw: Optional[Tuple[int, int]] = None, hws=None):
    """This epoch's permutation (injected, else drawn from `generator`),
    padded to whole batches -> (granule ids (steps, bpg), masks (steps, bs));
    `hw` as `_granule_batches` takes it.  `hws`: one real (height, width)
    per expert, or None where the expert fills the grid: masks (steps, E,
    bs), expert e's those `hw=hws[e]` gives.  On CUDA the ids go up from
    pinned memory, so the host does not wait for the card's queued work."""
    if perms is not None:
        perm = torch.from_numpy(np.array(perms[epoch], dtype=np.int64))
    else:
        perm = torch.randperm(geo.n_g, generator=generator)
    pad = torch.full((geo.steps * geo.bpg - geo.n_g,), geo.n_g, dtype=torch.int64)
    perm = torch.cat([perm, pad]).view(geo.steps, geo.bpg)
    if dev.type == "cuda":
        perm = perm.pin_memory()
    perm = perm.to(dev, non_blocking=True)

    def batches(hw_):
        return _granule_batches(perm, geo.n_g, H * W, geo.g, geo.steps, geo.ng_row, W, hw_)

    if hws is None:
        return batches(hw)
    by_hw = {h: batches(h) for h in dict.fromkeys(hws)}
    return by_hw[hws[0]][0], torch.stack([by_hw[h][1] for h in hws], dim=1)


def _granule_batches(perm: torch.Tensor, n_g: int, n: int, g: int, steps: int,
                     ng_row: int = 0, W: int = 0, hw: Optional[Tuple[int, int]] = None):
    """(steps, bs//g) padded permutation -> (clipped granule ids, (steps, bs)
    f32 masks): padding ids n_g are masked, and pixels past n on a flat
    grid, or the padding columns (j >= W) of a banded grid (`ng_row`
    granules a row); with `hw` (the real height and width of a
    bucket-padded tile), every pixel at row >= hw[0] or column >= hw[1]."""
    gvalid = perm < n_g
    gi = torch.clamp(perm, max=n_g - 1)
    if g == 1 and hw is None:
        return gi, gvalid.to(torch.float32)
    t = torch.arange(g, device=perm.device)
    if ng_row:
        cols = (gi % ng_row * g)[:, :, None] + t
        valid = cols < W
        if hw is not None:
            valid = valid & (cols < hw[1]) & ((gi // ng_row)[:, :, None] < hw[0])
    else:
        pix = gi[:, :, None] * g + t
        valid = pix < n
        if hw is not None:
            valid = valid & (pix // W < hw[0]) & (pix % W < hw[1])
    valid = gvalid[:, :, None] & valid
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
    staging: str = "cached",
    tap_dtype: Optional[torch.dtype] = None,
    use_fused: Optional[bool] = None,
    multi_k: Optional[int] = None,
    mm_dtype: Optional[str] = None,
    init: Optional[SirenParams] = None,
    perms: Optional[Sequence[np.ndarray]] = None,
    hw: Optional[Tuple[int, int]] = None,
    device=None,
    dp_group=None,
    timer: Optional[PhaseTimer] = None,
) -> FitResult:
    """Overfit one network to one image tile.

    plane: (C, H+2D, W+2D) int32 padded base plane; plane_scale: 0-d 1/max.
    labels: (C, H, W) integer LSB plane; label_scale: 1/(2^K-1) as float32.
    `staging` (features/engine.py; `codec.pick_staging` chooses it by
    size): how each step's batch is built — "cached", one row gather from
    the f32 feature cache; "full", from the integer tap matrix; "banded",
    from the row taps over the W-padded granule grid, padding columns
    masked; "gather", tap by tap from the plane, at granule 1.  "full" and
    "banded" without color features fall to "gather".  `tap_dtype`: the
    tap matrix's dtype ("full") or the row taps' raw dtype ("banded");
    default the smallest that holds the plane.  Every mode feeds the same
    step with values bit-identical to the feature cache's, so where the
    granule grids coincide (W % g == 0; granule 1 for "gather") every mode
    trains bit for bit as "cached" does.  Evals slice the feature cache
    ("cached"), the tap matrix ("full": its rows are pixels in row-major
    order, whatever g) or the plane (the slice path).

    `generator`: CPU generator for the init params and the per-epoch
    permutations; `init` / `perms` (one permutation of the granule ids per
    epoch) replace the draws when given.  `use_fused` (default: on CUDA)
    trains with the fused step, else with the exact autograd step, one
    call a step on views of a chunk of batches built at once (`chunk_steps`
    long, split by `_chunks`; counted in `fit.chunks`).
    `multi_k` (fused only; resolved by `multi_step_k`): k steps per
    `fused_multi_step` call (kernel K3) instead, chunks of k; the result is
    the per-step fit's.
    `mm_dtype` (None or "bfloat16"): the fused steps' product operands, as
    `fused_train_step` takes it; the exact step and the eval ignore it.

    Coordinate features (`fspec.use_coords`) come first in every mode: in
    the feature cache, from the pixel index in "full" batches, in the
    banded and gather builders; coordinates only (no colours) train on
    "cached" or "gather".  The "full" eval then takes the slice path.

    `hw`: the real (height, width) of a tile padded up to its bucket
    (`codec._pad_to_bucket`), H and W being the bucket's.  Pixels at row
    >= hw[0] or column >= hw[1] are masked out of every batch in every
    mode, and the eval's SSE is normalized by the real pixel count.

    `dp_group` (a process group; `parallel.shard.fit_dp`): data-parallel
    training over its ranks, the JAX package's `fit_core` under
    `shard_map` over "dp".  Every rank draws the same init and
    permutations; the batch rounds down to a multiple of the group size
    (`_batch_geometry`) and each rank builds its slice of every batch; each
    step is the exact autograd step with the SSE, the mask count and the
    gradients summed over the group (`_dp_step`), so every rank applies
    the same Adam update of the true mean gradient and the params stay
    bit-identical across ranks; the eval's row blocks are round-robined
    and their SSE summed.  The fused kernel does Adam inside its second
    pass, so `use_fused` and `multi_k` are off here.

    `timer` (None: no spans) records the fit's phases: `stage` (entry up
    to the first step: copies, labels, the staged features or taps,
    buffers, init), `stage_device` (its device seconds, CUDA events from
    the entry to the init's upload, which syncs the stream), `steps` (one
    span an epoch: its batches' staging, the step calls issued and the
    next epoch's permutation and masks; the first epoch's own too),
    `eval` (one span an eval: its issue and the sync that reads its MSE)
    and `eval_device` (the eval's device seconds, CUDA events); neither
    device span on the CPU.
    """
    if staging not in ("cached", "full", "banded", "gather"):
        raise ValueError(f"unknown staging mode {staging!r}")
    if staging in ("full", "banded") and not fspec.use_colors:
        staging = "gather"  # coords-only features have no taps to stage
    dev = resolve_device(device)
    if use_fused is None:
        use_fused = dev.type == "cuda"
    step_fn = fused_train_step if use_fused else reference_train_step
    dp, me = 1, 0
    if dp_group is not None:
        dp, me = dist.get_world_size(dp_group), dist.get_rank(dp_group)
        use_fused, multi_k = False, None
        step_fn = functools.partial(_dp_step, group=dp_group)
    span = timer if timer is not None else NoTimer()
    with torch.no_grad(), contextlib.ExitStack() as in_stage:
        in_stage.enter_context(span.phase("stage"))
        stage_done = in_stage.enter_context(span.device_phase("stage_device", dev))
        plane, plane_scale, labels = plane.to(dev), plane_scale.to(dev), labels.to(dev)
        dim_in = fspec.feature_dim(C)
        padded_in = pad_dim(dim_in)
        geo = _batch_geometry(tspec, H, W, staging, dp)
        bs, g, n_g, bpg, steps = geo.bs, geo.g, geo.n_g, geo.bpg, geo.steps
        bs_l, bpg_l = bs // dp, bpg // dp  # this rank's slice of a batch
        block_rows = feature_block_rows(H, W)
        k = multi_step_k(multi_k, use_fused, 1, bs, padded_in, steps)
        kb = k or chunk_steps(1, bs_l, padded_in, steps)  # steps staged at once

        # labels: flat granule rows (the evals'; the batches' but for
        # "banded", which gathers granule rows of the W-padded grid)
        ls = np.float32(label_scale)
        y_all = build_label_matrix(labels, -(-H * W // g) * g).to(torch.float32) * ls
        if staging == "banded":
            y_all_g = build_banded_labels(labels, H, W, g).to(torch.float32) * ls
        else:
            y_all_g = y_all.view(n_g, g * C)
        # one chunk's batches, step by step; columns past dim_in stay 0
        xbuf = torch.zeros((kb * bs_l, padded_in), dtype=torch.float32, device=dev)
        ybuf = torch.empty((kb * bpg_l, g * C), dtype=torch.float32, device=dev)
        xs, ys = xbuf.view(kb, bs_l, padded_in), ybuf.view(kb, bs_l, C)
        x_at, y_at = xs.unbind(0), ys.unbind(0)  # each step's views
        xeval = torch.zeros((block_rows * W, padded_in), dtype=torch.float32, device=dev)

        def slice_rows(r0):
            xeval[:, :dim_in] = row_block_features(plane, plane_scale, r0, fspec, H, W,
                                                   block_rows)
            return xeval

        if staging == "cached":
            x_cache = build_feature_cache(plane, plane_scale, fspec, H, W, padded_in, g=g)
            xg = x_cache.view(n_g, g * padded_in)
            staged = x_cache

            def stage_x(ids):
                torch.index_select(xg, 0, ids, out=xbuf.view(-1, g * padded_in)[: len(ids)])

            def x_rows(r0):
                return x_cache[r0 * W : (r0 + block_rows) * W]
        elif staging == "full":
            taps = build_tap_matrix(plane, fspec, H, W,
                                    tap_dtype or tap_matrix_dtype(int(plane.max()), fspec.relative),
                                    g=g)
            staged = taps

            def stage_x(ids):
                staged_features(taps, plane_scale, ids, out=xbuf[: len(ids) * g, :dim_in],
                                spec=fspec, H=H, W=W, g=g)

            def tap_rows(r0):
                xe = xeval[:, :dim_in]
                xe.copy_(taps.view(-1, dim_in)[r0 * W : (r0 + block_rows) * W])
                xe.mul_(plane_scale)
                return xeval

            # the tap matrix holds colours only: with coordinates, the slice path
            x_rows = slice_rows if fspec.use_coords else tap_rows
        elif staging == "banded":
            row_taps = build_row_taps(plane, fspec, H, W, g,
                                      tap_dtype or row_taps_dtype(int(plane.max())))
            staged = row_taps

            def stage_x(ids):
                banded_window_features(row_taps, plane_scale, ids, fspec, H, W, g,
                                       out=xbuf[: len(ids) * g, :dim_in])

            x_rows = slice_rows
        else:
            staged = plane.new_empty(0)  # nothing staged

            def stage_x(ids):
                gather_features(plane, plane_scale, ids, fspec, H, W, out=xbuf[: len(ids), :dim_in])

            x_rows = slice_rows

        def stage(ids):
            """The batches of granule ids `ids` (a chunk's, step-major)."""
            stage_x(ids)
            torch.index_select(y_all_g, 0, ids, out=ybuf[: len(ids)])

        if init is None:
            init = siren_init(generator, dim_in, C, mspec, pad_input_to=padded_in)
        stage_done()  # before the init's upload, whose copy syncs the stream
        params = init.map(lambda t: t.to(dev, torch.float32).clone())
        m_state = params.map(torch.zeros_like)
        v_state = params.map(torch.zeros_like)
        schedule = make_lr_schedule(tspec, steps)

        step_losses = torch.zeros((tspec.epochs, steps), dtype=torch.float32, device=dev)
        # an epoch's masks and losses, and this rank's views of them a step (made once)
        mask_buf = torch.empty((steps, bs), dtype=torch.float32, device=dev)
        loss_buf = torch.empty((steps,), dtype=torch.float32, device=dev)
        masks = mask_buf[:, me * bs_l : (me + 1) * bs_l]
        mask_at, loss_at = masks.unbind(0), loss_buf.unbind(0)

        def draw(epoch):
            """The epoch's granule ids (this rank's); its masks into mask_buf."""
            gi, m = _epoch_batches(epoch, perms, generator, geo, H, W, dev, hw)
            mask_buf.copy_(m)
            return gi[:, me * bpg_l : (me + 1) * bpg_l]

        best = params.map(torch.zeros_like)
        best_mse, best_epoch = np.float32(1e6), -1
        count = 0
        in_stage.close()
        gi = None
        for epoch in range(tspec.epochs):
            with span.phase("steps"):
                gi = draw(epoch) if gi is None else gi
                for s0, kc in _chunks(steps, kb):
                    stage(gi[s0 : s0 + kc].reshape(-1))
                    fit.chunks += 1
                    if k:
                        fused_multi_step(params, m_state, v_state, xs[:kc], ys[:kc],
                                         masks[s0 : s0 + kc],
                                         [schedule(count + s) for s in range(kc)], count + 1,
                                         mspec, C, loss_out=loss_buf[s0 : s0 + kc],
                                         mm_dtype=mm_dtype)
                        count += kc
                        continue
                    for s in range(s0, s0 + kc):
                        step_fn(params, m_state, v_state, x_at[s - s0], y_at[s - s0], mask_at[s],
                                schedule(count), count + 1, mspec, C, loss_out=loss_at[s],
                                mm_dtype=mm_dtype)
                        count += 1
                step_losses[epoch].copy_(loss_buf)
                # the next epoch's batches, drawn while the card works through this one's
                # steps (its masks land in mask_buf after them, in stream order)
                gi = draw(epoch + 1) if epoch + 1 < tspec.epochs else None

            if tspec.epochs == 1:
                best = params.map(torch.clone)
                best_mse, best_epoch = float(step_losses[0].mean()), 1
            elif (epoch + 1) % min(tspec.val_every, tspec.epochs) == 0:
                with span.phase("eval"), span.device_phase("eval_device", dev) as stop:
                    sse = blocks_mse(params, x_rows,
                                     lambda r0: y_all[r0 * W : (r0 + block_rows) * W],
                                     mspec, H, W, C, block_rows, fast_act=use_fused, hw=hw,
                                     dp_group=dp_group, dim_in=dim_in)
                    stop()
                    mse = float(sse)
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
            staging=staging,
            staged_bytes=staged.numel() * staged.element_size(),
        )


fit.chunks = 0  # chunks of steps staged (one pass each), over every fit


def _dp_step(params, m_state, v_state, x, y, mask, lr, step, mspec, dim_out, group,
             loss_out, mm_dtype=None):
    """One data-parallel exact step of `fit(dp_group=)`, in place on
    params/m/v: this rank's masked SSE and its gradients (autograd, exact
    `torch.sin`, f32 whatever `mm_dtype`), then one sum over the group of
    [SSE, mask count x C, every gradient], so each rank applies Adam to
    the gradient of the global loss SSE / max(count, 1), the true mean
    (the JAX package's dp loop psums the gradient of the already-psummed
    loss again and so hands optax dp times it; Adam cancels that factor
    but for eps)."""
    leaves = [t.detach().requires_grad_(True) for t in params.leaves()]
    L = len(params.weights)
    with torch.enable_grad():
        pred = forward(SirenParams(leaves[:L], leaves[L:]), x, mspec)
        se = ((pred - y) ** 2 * mask[:, None]).sum()
        grads = torch.autograd.grad(se, leaves)
    cnt = mask.sum() * dim_out
    flat = collect(torch.cat([se.detach().view(1), cnt.view(1)] + [g_.reshape(-1) for g_ in grads]),
                   group)
    inv = 1.0 / torch.clamp(flat[1], min=1.0)
    sizes = [t.numel() for t in leaves]
    gsum = [p.view(t.shape) * inv for p, t in zip(torch.split(flat[2:], sizes), leaves)]
    _apply_adam(params, m_state, v_state, gsum[:L], gsum[L:], lr, step)
    loss_out.copy_(flat[0] * inv)
    return params, m_state, v_state, loss_out


def _exact_expert_step(params, m_state, v_state, x, y, mask, lr, step, mspec, dim_out,
                       loss_out, mm_dtype=None):
    """The exact autograd step on each expert's slices in turn: what
    `fit_rate_experts(use_fused=False)` trains with (f32 whatever
    `mm_dtype`, as the exact oracle).  mask: (B,) shared or (E, B)."""
    for e in range(x.shape[0]):
        reference_train_step(unstack_params(params, e), unstack_params(m_state, e),
                             unstack_params(v_state, e), x[e], y[e],
                             mask[e] if mask.dim() == 2 else mask, lr, step,
                             mspec, dim_out, loss_out=loss_out[e])


def fit_rate_experts(
    img,
    Ks: Sequence[int],
    generator: Optional[torch.Generator],
    fspec: FeatureSpec,
    mspec: ModelSpec,
    tspec: TrainSpec,
    H: int,
    W: int,
    C: int,
    tap_dtypes: Optional[Sequence[torch.dtype]] = None,
    use_fused: Optional[bool] = None,
    staging: str = "full",
    multi_k: int = 0,
    mm_dtype: Optional[str] = None,
    img_of: Optional[Sequence[int]] = None,
    hws=None,
    init: Optional[SirenParams] = None,
    perms: Optional[Sequence[np.ndarray]] = None,
    device=None,
    timer: Optional[PhaseTimer] = None,
) -> FitResult:
    """Train one network per (image, rate point), all E = len(Ks) experts
    together.

    img: a (C, H, W) integer tensor of raw pixels, or a tuple of such
    images (or an (I, C, H, W) stack) with `img_of[e]` the image of expert
    e (default: every expert on image 0) — cross-image experts, so a
    dataset encode fills the expert batch across images of one shape.
    Each expert stages its own taps of its K-dependent MSB plane in
    `tap_dtypes` (default the smallest dtype): its integer tap matrix
    ("full" staging) or its raw row taps ("banded", over the W-padded
    granule grid, padding columns masked).  Labels share one store of raw
    pixels per image in use, in the same granule layout, gathered once per
    image a step; LSB_K = pixel & (2^K - 1) is applied per expert after
    the gather.  All experts start from the same init and see the same
    permutation each epoch, drawn as `fit` draws them (`init` / `perms`
    replace the draws when given), so expert e follows the trajectory that
    `fit` would follow at K = Ks[e] on image img_of[e]: every step is one
    expert step for all experts (`fused_expert_step`, kernel K2 on the
    card, whose expert e is bit-identical to K1; or, with
    `use_fused=False`, the exact autograd step per expert), and every
    `val_every` epochs each expert's full-image MSE (from its tap matrix,
    or by the slice path from its plane for "banded" and for coordinate
    features: values bit-identical to `fit`'s evals) decides its own
    strict-improvement best params.  Each epoch's batches are staged a
    chunk of `chunk_steps` steps at a time (`fit_rate_experts.chunks`), the
    step calls taking views of the chunk.  The eval runs expert by expert, one
    row block at a time (the JAX package's per-expert unrolled eval for
    large scenes, EVAL_UNROLL_PX, is therefore the only form here).

    `hws`: one real (height, width) per expert when H and W are a shape
    bucket's and the images are bucket-padded (`codec._pad_to_bucket`):
    each expert's pixels past its real shape are masked out of its
    batches, by (E, B) step masks, and out of its eval, which normalizes
    by its real pixel count; expert e is then `fit(hw=hws[e])`.  Per-expert
    masks keep the per-step path (`multi_step_k`: K4 shares one mask).

    Coordinate features (`fspec.use_coords`) are formed once per batch
    from the granules' pixel indices and put in front of every expert's
    colour taps (staged without coordinates), as `fit` stages them.

    `multi_k` (fused only; resolved by `multi_step_k`): k steps of every
    expert per `fused_expert_multi_step` call (kernel K4), each epoch split
    by `_chunks`, the chunk's batches staged at once in (k, E, bs,
    padded_in); the result is the per-step fit's.  `mm_dtype` as for
    `fit`: the fused expert steps' product operands.  `timer` as for `fit`:
    `stage` / `stage_device`, `steps`, and `eval` / `eval_device` once per
    expert eval.

    Returns a FitResult whose fields carry a leading expert axis.
    """
    if staging not in ("full", "banded"):
        raise ValueError(f"unknown staging mode {staging!r}")
    if not fspec.use_colors:
        raise ValueError("fit_rate_experts stages colour taps (callers: "
                         "codec._experts_compatible)")
    dev = resolve_device(device)
    if use_fused is None:
        use_fused = dev.type == "cuda"
    step_fn = fused_expert_step if use_fused else _exact_expert_step
    E = len(Ks)
    if isinstance(img, (tuple, list)):
        imgs = list(img)
    else:
        imgs = list(img.unbind(0)) if img.dim() == 4 else [img]
    img_of = tuple(img_of) if img_of is not None else (0,) * E
    if len(img_of) != E or max(img_of) >= len(imgs):
        raise ValueError(f"img_of {img_of} does not map {E} experts to {len(imgs)} images")
    used = sorted(set(img_of))
    per_expert_masks = hws is not None
    if hws is not None:
        # None where an expert fills the grid: its mask is the shared one
        hws = [None if (int(h), int(w)) == (H, W) else (int(h), int(w)) for h, w in hws]
        if len(hws) != E:
            raise ValueError(f"hws has {len(hws)} entries for {E} experts")
        if all(h is None for h in hws):
            hws = None
    span = timer if timer is not None else NoTimer()
    with torch.no_grad(), contextlib.ExitStack() as in_stage:
        in_stage.enter_context(span.phase("stage"))
        stage_done = in_stage.enter_context(span.device_phase("stage_device", dev))
        dev_imgs = {i: imgs[i].to(dev, torch.int32) for i in used}
        dim_in = fspec.feature_dim(C)
        padded_in = pad_dim(dim_in)
        nc = fspec.num_coord_features()
        fspec_nc = dataclasses.replace(fspec, use_coords=False)
        geo = _batch_geometry(tspec, H, W, staging)
        bs, g, n_g, bpg, steps = geo.bs, geo.g, geo.n_g, geo.bpg, geo.steps
        block_rows = feature_block_rows(H, W)
        k = multi_step_k(multi_k, use_fused, E, bs, padded_in, steps, per_expert_masks)
        banded = staging == "banded"
        if tap_dtypes is None:
            tap_dtypes = []
            for e, K in enumerate(Ks):
                mx = int(dev_imgs[img_of[e]].max()) >> K
                tap_dtypes.append(row_taps_dtype(mx) if banded
                                  else tap_matrix_dtype(mx, fspec.relative))

        scales, taps, planes = [], [], []
        for e, (K, dt) in enumerate(zip(Ks, tap_dtypes)):
            plane, scale = pad_plane(split_msb_lsb(dev_imgs[img_of[e]], K)[0], fspec.D)
            scales.append(scale)
            if banded or fspec.use_coords:  # the plane stays for the eval's slice path
                planes.append(plane)
            if banded:
                taps.append(build_row_taps(plane, fspec, H, W, g, dt))
            else:
                taps.append(build_tap_matrix(plane, fspec, H, W, dt, g=g))
        # raw pixels of each image in use, (n_g, g*C), and as (H, W, C) for the eval
        raw, raw_img = {}, {}
        for i in used:
            if banded:
                raw[i] = build_banded_labels(dev_imgs[i], H, W, g)
                raw_img[i] = raw[i].view(H, -1, C)[:, :W]
            else:
                raw[i] = build_granule_labels(dev_imgs[i], H, W, g)
                raw_img[i] = raw[i].view(-1, C)[: H * W].view(H, W, C)
        del dev_imgs
        # each expert's slot among the images in use
        slot = torch.tensor([used.index(i) for i in img_of], dtype=torch.int64, device=dev)
        kmasks = torch.tensor([(1 << K) - 1 for K in Ks], dtype=torch.int32, device=dev)
        kmasks = kmasks.view(E, 1, 1)
        lscales = torch.tensor([lsb_scale(K) for K in Ks], dtype=torch.float32, device=dev)
        lscales = lscales.view(E, 1, 1)
        # the staged batches of a chunk of kb steps: (kb, E, ...)
        kb = k or chunk_steps(E, bs, padded_in, steps)
        xbuf = torch.zeros((kb, E, bs, padded_in), dtype=torch.float32, device=dev)
        lbuf = torch.empty((len(used), kb * bpg, g * C), dtype=torch.int32, device=dev)
        ybits = torch.empty((kb, E, bs, C), dtype=torch.int32, device=dev)
        ybuf = torch.empty((kb, E, bs, C), dtype=torch.float32, device=dev)
        x_at, y_at = xbuf.unbind(0), ybuf.unbind(0)  # each step's views
        ar_g = torch.arange(g, device=dev)

        def stage(ids, kc):
            """The batches of kc steps (granule ids (kc * bpg,)) into the
            buffers' first kc entries."""
            for e in range(E):
                out = xbuf[:kc, e, :, nc:dim_in]
                if banded:
                    banded_window_features(taps[e], scales[e], ids, fspec_nc, H, W, g, out=out)
                else:
                    staged_features(taps[e], scales[e], ids, out=out)
            if nc:  # the granules' pixel coordinates, shared by every expert
                if banded:
                    ii = (ids // geo.ng_row)[:, None].expand(-1, g)
                    jj = (ids % geo.ng_row * g)[:, None] + ar_g
                else:
                    pix = ids[:, None] * g + ar_g
                    ii, jj = pix // W, pix % W
                coords = _coord_features(ii.reshape(-1), jj.reshape(-1), H, W, fspec)
                xbuf[:kc, :, :, :nc] = coords.view(kc, 1, bs, nc)
            for s, i in enumerate(used):  # one label gather per image
                torch.index_select(raw[i], 0, ids, out=lbuf[s, : kc * bpg])
            rows = lbuf[:, : kc * bpg].view(len(used), kc, bs, C)
            rows = rows.transpose(0, 1) if len(used) == 1 else rows[slot].transpose(0, 1)
            torch.bitwise_and(rows, kmasks, out=ybits[:kc])
            ybuf[:kc].copy_(ybits[:kc]).mul_(lscales)

        # the eval's inputs and labels, one row block at a time
        nb = block_rows * W
        xeval = torch.zeros((nb, padded_in), dtype=torch.float32, device=dev)

        def x_rows(e, r0):
            xe = xeval[:, :dim_in]
            if banded or fspec.use_coords:
                xe.copy_(row_block_features(planes[e], scales[e], r0, fspec, H, W, block_rows))
            else:
                xe.copy_(taps[e].view(-1, dim_in)[r0 * W : r0 * W + nb])
                xe.mul_(scales[e])
            return xeval

        def y_rows(e, r0):
            rows = raw_img[img_of[e]][r0 : r0 + block_rows].reshape(-1, C)
            return (rows & kmasks[e]).to(torch.float32) * lscales[e]

        if init is None:
            init = siren_init(generator, dim_in, C, mspec, pad_input_to=padded_in)
        stage_done()  # before the init's upload, whose copy syncs the stream
        params = init.map(lambda t: t.to(dev, torch.float32).expand(E, *t.shape).contiguous())
        m_state = params.map(torch.zeros_like)
        v_state = params.map(torch.zeros_like)
        schedule = make_lr_schedule(tspec, steps)

        losses = torch.zeros((tspec.epochs, steps, E), dtype=torch.float32, device=dev)
        # an epoch's masks and losses, and their views a step, as in `fit`
        masks = torch.empty((steps, bs) if hws is None else (steps, E, bs), dtype=torch.float32,
                            device=dev)
        loss_buf = torch.empty((steps, E), dtype=torch.float32, device=dev)
        mask_at, loss_at = masks.unbind(0), loss_buf.unbind(0)

        def draw(epoch):
            gi, m = _epoch_batches(epoch, perms, generator, geo, H, W, dev, hws=hws)
            masks.copy_(m)
            return gi

        best = params.map(torch.zeros_like)
        best_mse, best_epoch = [np.float32(1e6)] * E, [-1] * E
        count = 0
        in_stage.close()
        gi = None
        for epoch in range(tspec.epochs):
            with span.phase("steps"):
                gi = draw(epoch) if gi is None else gi
                for s0, kc in _chunks(steps, kb):
                    stage(gi[s0 : s0 + kc].reshape(-1), kc)
                    fit_rate_experts.chunks += 1
                    if k:
                        fused_expert_multi_step(params, m_state, v_state, xbuf[:kc], ybuf[:kc],
                                                masks[s0 : s0 + kc],
                                                [schedule(count + s) for s in range(kc)],
                                                count + 1, mspec, C,
                                                loss_out=loss_buf[s0 : s0 + kc],
                                                mm_dtype=mm_dtype)
                        count += kc
                        continue
                    for s in range(s0, s0 + kc):
                        step_fn(params, m_state, v_state, x_at[s - s0], y_at[s - s0], mask_at[s],
                                schedule(count), count + 1, mspec, C, loss_out=loss_at[s],
                                mm_dtype=mm_dtype)
                        count += 1
                losses[epoch].copy_(loss_buf)
                gi = draw(epoch + 1) if epoch + 1 < tspec.epochs else None  # as `fit` does

            if tspec.epochs == 1:
                best = params.map(torch.clone)
                best_mse = [float(losses[0, :, e].contiguous().mean()) for e in range(E)]
                best_epoch = [1] * E
            elif (epoch + 1) % min(tspec.val_every, tspec.epochs) == 0:
                for e in range(E):
                    with span.phase("eval"), span.device_phase("eval_device", dev) as stop:
                        sse = blocks_mse(
                            unstack_params(params, e), lambda r0: x_rows(e, r0),
                            lambda r0: y_rows(e, r0), mspec, H, W, C, block_rows,
                            fast_act=use_fused, hw=hws[e] if hws is not None else None,
                            dim_in=dim_in)
                        stop()
                        mse = float(sse)
                    if mse < best_mse[e]:  # strict improvement, per expert
                        for b_, p_ in zip(best.leaves(), params.leaves()):
                            b_[e].copy_(p_[e])
                        best_mse[e], best_epoch[e] = mse, epoch + 1
        step_losses = losses.permute(2, 0, 1).contiguous()  # (E, epochs, steps)
        return FitResult(
            params=best,
            best_mse=[float(v) for v in best_mse],
            best_epoch=[int(v) for v in best_epoch],
            final_params=params,
            epoch_losses=step_losses.mean(dim=2),
            step_losses=step_losses,
            staging=staging,
            staged_bytes=sum(t.numel() * t.element_size() for t in taps),
        )


fit_rate_experts.chunks = 0  # as `fit.chunks`
