"""SIREN MLP as a dataclass of tensors.

Same math and initialization scheme as the reference model
(reference LBDRNmodel.py:7-82, itself after lucidrains/siren-pytorch):

- ``num_layers`` hidden layers: ``sin(w0 * (x @ W + b))`` with w0 = 30,
- final layer: ``sigmoid(x @ W + b)``,
- init: W, b ~ U(-s, s) with s = 1/dim_in for the first layer and
  s = sqrt(c/dim_in)/w0 (c = 6) otherwise.

Layout follows the JAX package so parameters carry over unchanged:
``weights[i]`` is (in_i, out_i) and layer 0's input dimension is zero-padded
to a multiple of 128 (padded rows get zero gradient and stay zero under
Adam).  `flatten_params` strips the padding and emits the reference's
state-dict order (weight then bias, layer by layer, torch (out, in)
row-major), so weight streams interchange with the JAX package's.

Matmuls are full float32: callers on CUDA keep TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = False`, PyTorch's default).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from lbdrn_msic_tpu_torch.core.config import ModelSpec

LANE = 128


def pad_dim(d: int, multiple: int = LANE) -> int:
    return ((d + multiple - 1) // multiple) * multiple


@dataclasses.dataclass
class SirenParams:
    """weights[i]: (in_i, out_i); biases[i]: (out_i,). Layer 0 is padded."""

    weights: List[torch.Tensor]
    biases: List[torch.Tensor]

    def leaves(self) -> List[torch.Tensor]:
        return list(self.weights) + list(self.biases)

    def map(self, fn) -> "SirenParams":
        return SirenParams([fn(w) for w in self.weights], [fn(b) for b in self.biases])

    def to(self, device) -> "SirenParams":
        return self.map(lambda t: t.to(device))


def init_params(
    generator: torch.Generator,
    dim_in: int,
    dim_out: int,
    spec: ModelSpec,
    pad_input_to: int | None = None,
    device=None,
) -> SirenParams:
    """Initialize with the SIREN scheme from a CPU `generator`; the input
    dim is zero-padded.  Drawn on the CPU and then copied, so CPU and card
    runs start from the same numbers."""
    bc = spec.base_channel
    dims = [dim_in] + [bc] * spec.num_layers + [dim_out]
    padded_in = pad_dim(dim_in) if pad_input_to is None else pad_input_to
    weights, biases = [], []
    for layer in range(len(dims) - 1):
        d_in, d_out = dims[layer], dims[layer + 1]
        is_first = layer == 0
        w0 = spec.w0_initial if is_first else spec.w0
        s = (1.0 / d_in) if is_first else float(np.sqrt(spec.c / d_in) / w0)
        w = torch.rand((d_in, d_out), generator=generator) * (2 * s) - s
        b = torch.rand((d_out,), generator=generator) * (2 * s) - s
        if is_first and padded_in > d_in:
            w = torch.cat([w, torch.zeros((padded_in - d_in, d_out))], dim=0)
        weights.append(w)
        biases.append(b)
    params = SirenParams(weights=weights, biases=biases)
    return params if device is None else params.to(device)


def _sin(z: torch.Tensor, fast_act: bool) -> torch.Tensor:
    if fast_act:
        from lbdrn_msic_tpu_torch.ops.fused_step import sincos

        return sincos(z)[0]
    return torch.sin(z)


def forward(
    params: SirenParams, x: torch.Tensor, spec: ModelSpec, fast_act: bool = False,
) -> torch.Tensor:
    """x: (B, padded_dim_in) -> (B, dim_out).  Hidden sin(w0*z), final sigmoid.

    `fast_act=True` swaps torch.sin for the fused kernel's polynomial
    `sincos` — the training loop's eval on the fused path (kernel K6 on the
    card, `ops/fused_step.py::fused_eval_sse_plain` with this forward on the
    CPU), so best-epoch selection sees the activation the training steps
    used.  Decode keeps the default exact path.
    """
    n = len(params.weights)
    h = x
    for i in range(n - 1):
        w0 = spec.w0_initial if i == 0 else spec.w0
        z = torch.matmul(h, params.weights[i]) + params.biases[i]
        h = _sin(w0 * z, fast_act)
    z = torch.matmul(h, params.weights[-1]) + params.biases[-1]
    return torch.sigmoid(z)


def forward_experts(
    params: SirenParams, x: torch.Tensor, spec: ModelSpec, fast_act: bool = False,
) -> torch.Tensor:
    """Batched-expert forward: leaves carry a leading expert axis E
    (weights[i]: (E, in_i, out_i); biases[i]: (E, out_i)); x: (E, B, padded).
    One batched product per layer for all experts; same math as `forward`
    per expert.  Returns (E, B, dim_out)."""
    n = len(params.weights)
    h = x
    for i in range(n - 1):
        w0 = spec.w0_initial if i == 0 else spec.w0
        z = torch.bmm(h, params.weights[i]) + params.biases[i][:, None, :]
        h = _sin(w0 * z, fast_act)
    z = torch.bmm(h, params.weights[-1]) + params.biases[-1][:, None, :]
    return torch.sigmoid(z)


def stack_params(params_list: Sequence[SirenParams]) -> SirenParams:
    """Stack per-expert params along a new leading expert axis (contiguous,
    as the expert kernel takes them)."""
    return SirenParams(
        [torch.stack(ws) for ws in zip(*(p.weights for p in params_list))],
        [torch.stack(bs) for bs in zip(*(p.biases for p in params_list))],
    )


def unstack_params(params: SirenParams, e: int) -> SirenParams:
    """Expert e of stacked params, as views: writing into them writes into
    the stack."""
    return params.map(lambda t: t[e])


def pad_features(x: torch.Tensor, padded_dim: int) -> torch.Tensor:
    """Zero-pad the feature axis to the model's padded input width."""
    d = x.shape[-1]
    if d == padded_dim:
        return x
    return torch.cat([x, x.new_zeros((*x.shape[:-1], padded_dim - d))], dim=-1)


def params_from_numpy(
    weights: Sequence[np.ndarray], biases: Sequence[np.ndarray], device="cpu"
) -> SirenParams:
    """Parameters given as numpy arrays in the JAX layout (for example the
    JAX package's SirenParams, fetched to the host) -> SirenParams.  Expert
    stacks ((E, in, out) weights, (E, out) biases) carry across as they are."""
    conv = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return SirenParams([conv(w) for w in weights], [conv(b) for b in biases])


def params_to_numpy(params: SirenParams):
    """(weights, biases) as lists of float32 numpy arrays in the JAX layout."""
    host = lambda t: t.detach().cpu().numpy().astype(np.float32)
    return [host(w) for w in params.weights], [host(b) for b in params.biases]


def flatten_params(params: SirenParams, dim_in: int) -> np.ndarray:
    """Serialize to a flat float32 vector in reference state-dict order
    (reference encode.py:124-128): per layer, weight then bias; weight as
    torch (out, in) row-major; layer 0's padded input rows stripped."""
    ws, bs = params_to_numpy(params)
    out = []
    for i, (w, b) in enumerate(zip(ws, bs)):
        if i == 0:
            w = w[:dim_in]
        out.append(w.T.reshape(-1))
        out.append(b.reshape(-1))
    return np.concatenate(out).astype(np.float32)


def unflatten_params(
    flat: np.ndarray,
    dim_in: int,
    dim_out: int,
    spec: ModelSpec,
    pad_input_to: int | None = None,
    device="cpu",
) -> SirenParams:
    """Inverse of flatten_params; re-applies the input padding."""
    bc = spec.base_channel
    dims = [dim_in] + [bc] * spec.num_layers + [dim_out]
    padded_in = pad_dim(dim_in) if pad_input_to is None else pad_input_to
    weights, biases = [], []
    k = 0
    for layer in range(len(dims) - 1):
        d_in, d_out = dims[layer], dims[layer + 1]
        w = flat[k : k + d_in * d_out].reshape(d_out, d_in).T.astype(np.float32)
        k += d_in * d_out
        b = flat[k : k + d_out].astype(np.float32)
        k += d_out
        if layer == 0 and padded_in > d_in:
            w = np.concatenate([w, np.zeros((padded_in - d_in, d_out), np.float32)])
        weights.append(w)
        biases.append(b)
    if k != flat.size:
        raise ValueError(f"parameter vector length {flat.size} != expected {k}")
    return params_from_numpy(weights, biases, device)
