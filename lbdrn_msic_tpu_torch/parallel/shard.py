"""Scale-out over the ranks of a torch.distributed world, one process per
card (the JAX package's `parallel/shard.py` over a device mesh).

The model is SPMD: every rank calls an entry point with the same arguments
and gets the same result, as each process of a multi-host JAX program
does.  The mesh is a `DeviceMesh` of the world's ranks with dims ("ep",
"dp"), and the codec's two axes of parallelism are:

- **dp** (pixel-batch data parallelism, `fit_dp`): one tile's overfit loop
  on every rank of the "dp" axis, each rank training on its slice of every
  batch; the loss terms and the gradients are summed over the axis, so the
  params evolve as in the single-card loop and stay bit-identical across
  the ranks.
- **ep** (expert fan-out, `fit_experts`): independent (image, K) networks,
  a contiguous share of them trained on each rank of the "ep" axis with
  kernel K2 on its card, then gathered, so every rank holds every expert.

Every collective goes through `parallel.distributed.collect`.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _set_pg_timeout
from torch.distributed.device_mesh import DeviceMesh

from lbdrn_msic_tpu_torch import resolve_device
from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.models.siren import SirenParams, init_params, pad_dim
from lbdrn_msic_tpu_torch.parallel.distributed import DEFAULT_TIMEOUT, collect
from lbdrn_msic_tpu_torch.train.loop import FitResult, _batch_geometry, fit, fit_rate_experts

AXES = ("ep", "dp")


def make_mesh(dp: int = 1, ep: int = 1, timeout: datetime.timedelta = DEFAULT_TIMEOUT
              ) -> DeviceMesh:
    """The ("ep", "dp") mesh of the world's ranks: rank = ep_index * dp +
    dp_index, as the JAX package reshapes its devices to (ep, dp).  dp * ep
    must equal the world size (in SPMD a rank outside the mesh would have
    no role).  Its device type follows the default group's backend: "cuda"
    for NCCL, "cpu" for gloo (whose collectives go through host memory).
    Each axis's group gets `timeout` (torch would give a subgroup 10 or 30
    minutes), so a rank that fails stops its peers' collectives soon."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh ep={ep} x dp={dp} needs an initialised torch.distributed world: "
            f"start every rank under torchrun (or call parallel.distributed."
            f"initialize_cluster)")
    world = dist.get_world_size()
    if dp * ep != world:
        raise ValueError(f"mesh ep={ep} x dp={dp} needs {ep * dp} ranks, the world has {world}")
    device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    mesh = DeviceMesh(device_type, torch.arange(ep * dp).reshape(ep, dp), mesh_dim_names=AXES)
    for name in AXES:
        _set_pg_timeout(timeout, mesh.get_group(name))
    return mesh


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """The mesh's size along `name`; 1 without a mesh (JAX
    ``mesh.shape.get(name, 1)``)."""
    if mesh is None:
        return 1
    return mesh.size(AXES.index(name))


def axis_rank(mesh: Optional[DeviceMesh], name: str) -> int:
    """This rank's coordinate along `name`; 0 without a mesh."""
    return 0 if mesh is None else mesh.get_local_rank(name)


def fit_dp(mesh: DeviceMesh, plane: torch.Tensor, plane_scale: torch.Tensor,
           labels: torch.Tensor, label_scale: float, generator: Optional[torch.Generator],
           fspec: FeatureSpec, mspec: ModelSpec, tspec: TrainSpec, H: int, W: int, C: int,
           staging: str = "cached", tap_dtype: Optional[torch.dtype] = None,
           init: Optional[SirenParams] = None, perms: Optional[Sequence[np.ndarray]] = None,
           hw=None, device=None) -> FitResult:
    """Data-parallel fit of ONE tile over the mesh's "dp" axis: `fit` with
    the axis's group (`fit(dp_group=)`).  Every rank passes the same
    inputs (and a generator in the same state) and returns the same
    FitResult."""
    return fit(plane, plane_scale, labels, label_scale, generator, fspec, mspec, tspec,
               H, W, C, staging=staging, tap_dtype=tap_dtype, init=init, perms=perms, hw=hw,
               device=device, dp_group=mesh.get_group("dp"))


def fit_experts(mesh: DeviceMesh, img, Ks: Sequence[int], generator: Optional[torch.Generator],
                fspec: FeatureSpec, mspec: ModelSpec, tspec: TrainSpec, H: int, W: int,
                C: int, tap_dtypes=None, use_fused: Optional[bool] = None,
                staging: str = "full", img_of: Optional[Sequence[int]] = None, hws=None,
                init: Optional[SirenParams] = None,
                perms: Optional[Sequence[np.ndarray]] = None, device=None) -> FitResult:
    """Train E = len(Ks) independent experts fanned out over the mesh's
    "ep" axis; the arguments are `fit_rate_experts`'s for all E.

    With rounds = ceil(E / ep), the rank at ep coordinate r trains experts
    [r * rounds, (r + 1) * rounds) through `fit_rate_experts` (kernel K2 on
    its card, no collective inside a step); ranks past the last expert
    train nothing.  Then one gather over the ep group gives every rank the
    E-leading FitResult: params, final params, losses, best MSE and epoch
    of every expert, `fit_rate_experts`' own for all E bit for bit (expert
    e of K2 is K1 on its slices whatever E).  `staged_bytes` is the most
    one rank staged.  Every rank passes the same inputs and a generator in
    the same state.  The JAX package's `_expert_vfit` (its jit cache of
    the vmapped fit, one traced program per signature) has no counterpart:
    K2 is built once and launched at any E."""
    dev = resolve_device(device)
    E = len(Ks)
    ep, r = axis_size(mesh, "ep"), axis_rank(mesh, "ep")
    rounds = -(-E // ep)
    mine = list(range(min(r * rounds, E), min((r + 1) * rounds, E)))
    sub = lambda xs: None if xs is None else [xs[e] for e in mine]
    # the gathered layout of one expert: params, final params, epoch and
    # step losses, best MSE and epoch (a rank with no expert still sends it)
    dim_in = fspec.feature_dim(C)
    shapes = [t.shape for t in init_params(torch.Generator().manual_seed(0), dim_in, C, mspec,
                                           pad_input_to=pad_dim(dim_in)).leaves()]
    steps = _batch_geometry(tspec, H, W, staging).steps
    sizes = [int(np.prod(s)) for s in shapes] * 2 + [tspec.epochs, tspec.epochs * steps, 1, 1]
    per = sum(sizes)
    buf = torch.zeros(rounds * per + 1, dtype=torch.float64, device=dev)
    if mine:
        res = fit_rate_experts(img, sub(Ks), generator, fspec, mspec, tspec, H, W, C,
                               tap_dtypes=sub(tap_dtypes), use_fused=use_fused, staging=staging,
                               img_of=sub(img_of), hws=sub(hws), init=init, perms=perms, device=dev)
        for s in range(len(mine)):
            parts = ([t[s].reshape(-1) for t in res.params.leaves()]
                     + [t[s].reshape(-1) for t in res.final_params.leaves()]
                     + [res.epoch_losses[s], res.step_losses[s].reshape(-1),
                        torch.tensor([res.best_mse[s], res.best_epoch[s]], device=dev)])
            buf[s * per : (s + 1) * per] = torch.cat([p.to(torch.float64) for p in parts])
        buf[-1] = res.staged_bytes
    got = collect(buf, mesh.get_group("ep"), op="gather")  # (ep, rounds * per + 1)
    rows = got[:, :-1].reshape(-1, per)[:E]  # expert-major, past-the-end slots dropped
    fields = torch.split(rows, sizes, dim=1)
    n = len(shapes)
    leaves = [f.to(torch.float32).reshape(E, *s) for f, s in zip(fields, shapes * 2)]
    L = len(shapes) // 2
    return FitResult(
        params=SirenParams(leaves[:L], leaves[L:n]),
        best_mse=[float(v) for v in fields[-2][:, 0].tolist()],
        best_epoch=[int(v) for v in fields[-1][:, 0].tolist()],
        final_params=SirenParams(leaves[n : n + L], leaves[n + L : 2 * n]),
        epoch_losses=fields[2 * n].to(torch.float32),
        step_losses=fields[2 * n + 1].to(torch.float32).reshape(E, tspec.epochs, steps),
        staging=staging,
        staged_bytes=int(got[:, -1].max()),
    )

