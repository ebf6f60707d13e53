"""Fused SIREN training step: one hand-written CUDA kernel source on the
card (`csrc/fused_step.cu`), its plain PyTorch versions beside it, and the
autodiff oracle; for one network (K1, `fused_train_step`), for E
independent networks in one launch (K2, `fused_expert_step`), and k
sequential steps of either in one persistent launch (K3
`fused_multi_step`, K4 `fused_expert_multi_step`).

One step performs, for one batch:

    forward (nl+1 full-f32 matmuls, sin via the shared-reduction `sincos`,
    sigmoid head) -> masked squared error -> hand-derived backward ->
    Adam with torch bias-correction semantics (reference encode.py:84 uses
    torch.optim.Adam defaults), updating params, m and v in place.

`fused_train_step` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; `reference_train_step` is the exact
`torch.sin` + autograd step (or, with `match_kernel=True`, the kernel's own
numerics) that `use_fused=False` trains with.

`fused_eval_sse` (K6, the same source) is the fast-act eval's masked SSE of
one row block (`train/loop.py::blocks_mse`): the forward of
`forward(fast_act=True)`, the squared error and its sum in one launch pair,
beside its plain version `fused_eval_sse_plain`.

`mm_dtype` (every step function; default None, full f32): "bfloat16"
rounds both operands of every product to bf16 and accumulates in f32, the
JAX package's `mm_dtype` (lbdrn_msic_tpu/ops/fused_step.py::_fwd_bwd).  It
is opt-in: nothing in the codec sets it.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from lbdrn_msic_tpu_torch.core.config import ModelSpec
from lbdrn_msic_tpu_torch.models.siren import SirenParams, forward, unstack_params

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

# sincos: minimax polynomials on [-pi/2, pi/2] (degree 9 odd / 8 even),
# f32-rounded constants; _PI_LO is pi - f32(pi) so the two-term Cody-Waite
# reduction keeps |r| error ~ ulp(u).  Values are the f32 roundings, so a
# Python-scalar operation on an f32 tensor uses exactly these constants.
_f32 = lambda v: float(np.float32(v))
_INV_PI = _f32(0.31830987449645996)
_PI_HI = _f32(3.14159274101257324)
_PI_LO = _f32(-8.742277657347586e-08)
_SIN_P = tuple(map(_f32, (1.0, -0.16666647791862488, 0.008332899771630764,
                          -0.00019800907466560602, 2.5905085294652963e-06)))
_COS_P = tuple(map(_f32, (0.9999999403953552, -0.4999990463256836,
                          0.04166358709335327, -0.001385371433570981,
                          2.31541689572623e-05)))

MAX_LAYERS = 16
THREADS = 256
ROWS = 64  # batch rows per CTA of the kernel's first pass
EVAL_ROWS = 128  # the most rows of a K6 tile


def sincos(u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin u, cos u) from ONE shared range reduction: u = k*pi + r with one
    round (half to even), sign (-1)^k folded into both, two short Horner
    polynomials sharing r^2.  |err| < 2e-7 for |u| <= 3, < 2e-6 for
    |u| <= 30, growing ~ulp(u) with |u|."""
    k = torch.round(u * _INV_PI)
    r = (u - k * _PI_HI) - k * _PI_LO
    f = k * 0.5
    f = f - torch.round(f)
    sg = 1.0 - 8.0 * (f * f)
    r2 = r * r
    ps = torch.full_like(u, _SIN_P[4])
    pc = torch.full_like(u, _COS_P[4])
    for s_c, c_c in zip(_SIN_P[3::-1], _COS_P[3::-1]):
        ps = ps * r2 + s_c
        pc = pc * r2 + c_c
    return (sg * r) * ps, sg * pc


def layer_w0s(mspec: ModelSpec) -> List[float]:
    """Per-layer w0 (the sigmoid head's entry is unused)."""
    return [mspec.w0_initial] + [mspec.w0] * (mspec.num_layers - 1) + [0.0]


def mm_bf16(mm_dtype) -> bool:
    """True for mm_dtype "bfloat16", False for None; raises otherwise."""
    if mm_dtype not in (None, "bfloat16"):
        raise ValueError(f"mm_dtype must be None or 'bfloat16', got {mm_dtype!r}")
    return mm_dtype is not None


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def fwd_bwd(x, y, mask, ws, bs, w0s, mm_dtype=None):
    """Forward + hand-derived backward for a batch.

    mask: (B, 1).  Returns (sse, dws, dbs): the masked squared-error sum and
    the *unscaled* gradients d(sum se)/dW, d(sum se)/db (biases (1, out)).
    `mm_dtype` "bfloat16": both operands of every product rounded to bf16;
    their products are exact in f32, so the f32 matmul is the bf16 product
    with f32 accumulation.
    """
    if mm_bf16(mm_dtype):
        matmul = lambda a, b: torch.matmul(_bf16(a), _bf16(b))
    else:
        matmul = torch.matmul
    L = len(ws)
    hs = [x]
    coss = []
    h = x
    for l in range(L - 1):
        z = matmul(h, ws[l]) + bs[l]
        s, c = sincos(w0s[l] * z)
        coss.append(w0s[l] * c)
        h = s
        hs.append(h)
    z_last = matmul(h, ws[L - 1]) + bs[L - 1]
    p = 1.0 / (1.0 + torch.exp(-z_last))
    diff = (p - y) * mask
    sse = torch.sum(diff * diff)
    g = 2.0 * diff * (p * (1.0 - p))
    dws: list = [None] * L
    dbs: list = [None] * L
    for l in range(L - 1, -1, -1):
        dws[l] = matmul(hs[l].T, g)
        dbs[l] = torch.sum(g, dim=0, keepdim=True)
        if l > 0:
            g = matmul(g, ws[l].T) * coss[l - 1]
    return sse, dws, dbs


def adam(theta, grad, m, v, lr, c1, c2):
    """One Adam update with torch bias-correction semantics, in the form
    theta - lr*(m*c1)/(sqrt(v*c2)+eps) with c1 = 1/(1-b1^t), c2 = 1/(1-b2^t)."""
    m_new = ADAM_B1 * m + (1.0 - ADAM_B1) * grad
    v_new = ADAM_B2 * v + (1.0 - ADAM_B2) * grad * grad
    theta_new = theta - lr * (m_new * c1) / (torch.sqrt(v_new * c2) + ADAM_EPS)
    return theta_new, m_new, v_new


@functools.lru_cache(maxsize=1 << 17)
def bias_corrections(step: int) -> Tuple[float, float]:
    """(c1, c2) = (1/(1-b1^t), 1/(1-b2^t)) in float32 for 1-indexed `step`
    (remembered: every fit asks for the same steps)."""
    t = np.float32(step)
    one = np.float32(1.0)
    c1 = one / (one - np.float32(ADAM_B1) ** t)
    c2 = one / (one - np.float32(ADAM_B2) ** t)
    return float(c1), float(c2)


def _apply_adam(params, m_state, v_state, grads_w, grads_b, lr, step, corrections=None):
    """Adam over every leaf, writing params, m and v in place; `corrections`
    (c1, c2) replaces the bias corrections of `step` when given."""
    c1, c2 = corrections or bias_corrections(step)
    lr = float(np.float32(lr))
    for th, g, m, v in zip(
        params.weights + params.biases, list(grads_w) + list(grads_b),
        m_state.weights + m_state.biases, v_state.weights + v_state.biases,
    ):
        a, b_, c = adam(th, g, m, v, lr, c1, c2)
        th.copy_(a)
        m.copy_(b_)
        v.copy_(c)


def fused_train_step_plain(params, m_state, v_state, x, y, mask, lr, step,
                           mspec: ModelSpec, dim_out: int, loss_out=None, mm_dtype=None,
                           corrections=None):
    """The kernel's function in plain torch ops: same sincos, same
    hand-derived backward, same Adam form.  Updates params/m/v in place and
    returns (params, m, v, loss)."""
    sse, dws, dbs = fwd_bwd(
        x, y, mask.reshape(-1, 1), params.weights,
        [b.reshape(1, -1) for b in params.biases], layer_w0s(mspec), mm_dtype,
    )
    inv_scale = 1.0 / (torch.clamp(mask.sum(), min=1.0) * dim_out)
    _apply_adam(
        params, m_state, v_state,
        [d * inv_scale for d in dws], [d.reshape(-1) * inv_scale for d in dbs],
        lr, step, corrections,
    )
    loss = sse * inv_scale
    if loss_out is not None:
        loss_out.copy_(loss)
        return params, m_state, v_state, loss_out
    return params, m_state, v_state, loss


class _StepArgs(ctypes.Structure):
    """Mirror of `StepArgs` in csrc/fused_step.cu."""

    _fields_ = (
        [(n, ctypes.c_void_p * MAX_LAYERS) for n in ("w", "b", "mw", "vw", "mb", "vb")]
        + [("dims", ctypes.c_int32 * (MAX_LAYERS + 1)),
           ("w0", ctypes.c_float * MAX_LAYERS),
           ("L", ctypes.c_int32), ("B", ctypes.c_int32), ("rows", ctypes.c_int32),
           ("stage_w", ctypes.c_int32), ("mm_bf16", ctypes.c_int32)]
    )


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def row_stride(n: int) -> int:
    """Row stride (floats) in shared memory of an activation, gradient or x
    tile of width n: a multiple of 4 (16-byte rows for float4 reads) that is
    not a multiple of 32, so two rows one warp instruction reads lie on
    different banks (csrc/step_async.cuh::row_stride)."""
    r = _r4(n)
    return r + 4 if r % 32 == 0 else r


def smem_bytes(dims: List[int], rows: int, stage_w: bool = True) -> int:
    """Dynamic shared memory of the first pass (the kernel's carve-up, in
    order): one mbarrier per layer, the x tile at `row_stride(F)`, y and
    mask rows, the block-sum buffer, two gradient buffers at the widest
    `row_stride`; with `stage_w`, every weight and bias (each 16-byte
    aligned) and W^T of layers 1.. (dout rows at `row_stride(din)`); then
    the hidden activations and their w0*cos caches."""
    L = len(dims) - 1
    F, C = dims[0], dims[-1]
    ldg = max(row_stride(d) for d in dims[1:])
    n = _r4(2 * L) + rows * row_stride(F) + _r4(rows * C) + _r4(rows) + THREADS
    n += 2 * rows * ldg
    if stage_w:
        n += sum(_r4(dims[l] * dims[l + 1]) + _r4(dims[l + 1]) for l in range(L))
        n += sum(dims[l + 1] * row_stride(dims[l]) for l in range(1, L))
    n += 2 * rows * sum(row_stride(d) for d in dims[1:L])
    return 4 * n


def scratch_stride(P: int) -> int:
    """Floats per partial row (P gradients, the SSE, the mask count), padded
    to 16 bytes."""
    return _r4(P + 2)


def cta_layout(dims: List[int], smem_limit: int, size: Callable = smem_bytes,
               most_rows: int = ROWS) -> Tuple[int, bool]:
    """(rows per CTA, weights staged in shared memory?) for these widths:
    the most rows from `most_rows` down (halving) with the weights staged,
    else the most rows without.  `size(dims, rows, stage_w)`: the kernel's
    shared-memory bytes, K1-K4's `smem_bytes` by default (K6 passes
    `eval_smem_bytes` and EVAL_ROWS)."""
    for stage_w in (True, False):
        rows = most_rows
        while rows >= 8:
            if size(dims, rows, stage_w) <= smem_limit:
                return rows, stage_w
            rows //= 2
    raise ValueError(f"layer widths {dims} need {size(dims, 8, False)} B "
                     f"of shared memory; the device allows {smem_limit}")


def eval_smem_bytes(dims: List[int], rows: int, stage_w: bool = True) -> int:
    """Dynamic shared memory of K6's first pass (the kernel's carve-up, in
    order): three mbarriers, the per-thread sums and the block-sum buffer;
    with `stage_w`, every weight and bias (layer 0's first dims[0] rows,
    dims[0] being the live input width; each 16-byte aligned); up to two
    hidden-activation buffers at the widest hidden `row_stride`; two ring
    stages of x rows at `row_stride(dims[0])` and their labels."""
    L = len(dims) - 1
    ldh = max([4] + [row_stride(d) for d in dims[1:L]])
    n = 8 + 2 * THREADS
    if stage_w:
        n += sum(_r4(dims[l] * dims[l + 1]) + _r4(dims[l + 1]) for l in range(L))
    n += min(L - 1, 2) * rows * ldh
    n += 2 * (rows * row_stride(dims[0]) + _r4(rows * dims[-1]))
    return 4 * n


_lib = None
_smem_optin = 0
# K1's (key True) and K2's (key False) bound launch plan: one leaf set a
# fit, so every step after the first reuses it (`_launch`)
_plans: dict = {}


def _kernel_lib():
    global _lib, _smem_optin
    if _lib is None:
        from lbdrn_msic_tpu_torch.ops._build import load

        lib = load("fused_step")
        i64, ptr, i32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
        lib.lbdrn_smem_optin.argtypes = []
        lib.lbdrn_smem_optin.restype = i32
        lib.lbdrn_fused_step.restype = i32
        lib.lbdrn_fused_step.argtypes = [
            ctypes.POINTER(_StepArgs), i32, ptr, ptr, ptr, i32, ptr, i32, i32, i32, ptr,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ptr,
        ]
        lib.lbdrn_fused_multi_step.restype = i32
        lib.lbdrn_fused_multi_step.argtypes = [
            ctypes.POINTER(_StepArgs), i32, i32, ptr, i64, i64, ptr, i64, i64, ptr, i64, i64,
            ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ctypes.POINTER(ctypes.c_int),
        ]
        lib.lbdrn_eval_ctas.argtypes = [i32, i32]
        lib.lbdrn_eval_ctas.restype = i32
        lib.lbdrn_fused_eval_sse.restype = i32
        lib.lbdrn_fused_eval_sse.argtypes = [
            ctypes.POINTER(_StepArgs), ptr, i32, ptr, i32, i32, i32, i32, ptr, i32, i32, ptr, ptr,
        ]
        _smem_optin = lib.lbdrn_smem_optin()
        _lib = lib
    return _lib


def _check(t: torch.Tensor, shape, what, device: torch.device):
    """Raise unless t is a contiguous float32 tensor of `shape` on `device`.
    `what` names it: a string, or a tuple of parts joined only to raise (the
    launchers check every leaf at every step)."""
    if (t.device == device and t.dtype == torch.float32 and t.shape == shape
            and t.is_contiguous()):
        return
    what = what if isinstance(what, str) else " ".join(map(str, what))
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32 on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    raise ValueError(f"{what}: must be contiguous")


def _fits(t: torch.Tensor, shape, dev: torch.device) -> bool:
    """`_check`'s test, without its messages."""
    return (t.dtype is torch.float32 and t.shape == shape and t.device == dev
            and t.is_contiguous())


def _raw_stream(dev: torch.device) -> int:
    """The handle of `dev`'s current CUDA stream, which the launches use."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _step_args(params: SirenParams, m_state: SirenParams, v_state: SirenParams,
               B: int, F: int, mspec: ModelSpec, dim_out: int, lead: tuple,
               dev: torch.device, mm_dtype=None):
    """Check the param and Adam-state leaves (each with the leading axes
    `lead`: () for one network, (E,) for experts) and return (StepArgs,
    shared-memory bytes, row tiles, P) for them, batch B and `mm_dtype`."""
    bf16 = mm_bf16(mm_dtype)
    L = len(params.weights)
    if L > MAX_LAYERS or L != mspec.num_layers + 1:
        raise ValueError(f"unsupported layer count {L}")
    dims = [F] + [w.shape[-1] for w in params.weights]
    if dims[-1] != dim_out:
        raise ValueError(f"head width {dims[-1]} != dim_out {dim_out}")
    for l in range(L):
        for st, nm in ((params, "param"), (m_state, "m"), (v_state, "v")):
            _check(st.weights[l], (*lead, dims[l], dims[l + 1]), (nm, "weight", l), dev)
            _check(st.biases[l], (*lead, dims[l + 1]), (nm, "bias", l), dev)

    rows, stage_w = cta_layout(dims, _smem_optin)
    args = _StepArgs()
    for name, ts in (("w", params.weights), ("b", params.biases),
                     ("mw", m_state.weights), ("vw", v_state.weights),
                     ("mb", m_state.biases), ("vb", v_state.biases)):
        arr = getattr(args, name)
        for l, t in enumerate(ts):
            arr[l] = t.data_ptr()
    for l, d in enumerate(dims):
        args.dims[l] = d
    for l, w0 in enumerate(layer_w0s(mspec)):
        args.w0[l] = w0
    args.L, args.B, args.rows, args.stage_w = L, B, rows, int(stage_w)
    args.mm_bf16 = int(bf16)
    P = sum(dims[l] * dims[l + 1] + dims[l + 1] for l in range(L))
    return args, smem_bytes(dims, rows, stage_w), -(-B // rows), P


class _Plan:
    """K1's or K2's launches for one (params, m, v) leaf set, bound by
    `_bind` after every check: the StepArgs, the shared memory and row
    tiles, the scratch rows of the partials (owned by the plan and reused
    by its launches in stream order on the one stream they run on, as K1/K2's
    successive launches run), and the shapes a call's y, mask and loss
    must have.  `key`: x's shape, the mask's rank, the head width, the
    spec, `mm_dtype` and the stream it was bound at."""

    __slots__ = ("leaves", "key", "argp", "n_exp", "smem", "n_cta", "S", "scratch",
                 "scratch_ptr", "mask_stride", "lead", "y_shape", "mask_shape", "dev")

    def __init__(self, leaves, key, args, smem, n_cta, P, lead, mask_stride, dev):
        B = key[0][-2]
        self.leaves, self.key, self.argp = leaves, key, ctypes.pointer(args)
        self.n_exp = lead[0] if lead else 1
        self.smem, self.n_cta, self.S = smem, n_cta, scratch_stride(P)
        self.scratch = torch.empty((self.n_exp, n_cta, self.S), dtype=torch.float32, device=dev)
        self.scratch_ptr = self.scratch.data_ptr()
        self.mask_stride, self.lead = mask_stride, lead
        self.y_shape = (*lead, B, key[2])
        self.mask_shape = (*lead, B) if mask_stride else (B,)
        self.dev = dev

    def serves(self, key, leaves, x, y, mask, loss_out) -> bool:
        """True if a launch at `key` with these leaves and tensors may
        use this plan: the same leaf objects, and x, y, mask and loss as
        `_bind`'s checks would pass them."""
        d = self.dev
        return (self.key == key and len(leaves) == len(self.leaves)
                and all(map(operator.is_, leaves, self.leaves))
                and _fits(x, key[0], d) and _fits(y, self.y_shape, d)
                and _fits(mask, self.mask_shape, d)
                and (loss_out is None or _fits(loss_out, self.lead, d)))


def _bind(params, m_state, v_state, x, y, mask, mspec, dim_out, loss_out, E, mm_dtype,
          leaves, key) -> _Plan:
    """Every check of a launch, then the plan for these leaves (counted in
    `fused_train_step.binds` or `fused_expert_step.binds`)."""
    lead = () if E is None else (E,)
    B, F = x.shape[-2:]
    dev = x.device
    _check(x, (*lead, B, F), "x", dev)
    _check(y, (*lead, B, dim_out), "y", dev)
    if mask.dim() == 2 and E is not None:
        _check(mask, (E, B), "mask", dev)
        mask_stride = B
    else:
        _check(mask, (B,), "mask", dev)
        mask_stride = 0
    args, smem, n_cta, P = _step_args(params, m_state, v_state, B, F, mspec, dim_out, lead, dev,
                                      mm_dtype)
    if loss_out is not None:
        _check(loss_out, lead, "loss_out", dev)
    plan = _Plan(leaves, key, args, smem, n_cta, P, lead, mask_stride, dev)
    _plans[E is None] = plan
    (fused_train_step if E is None else fused_expert_step).binds += 1
    return plan


def _launch(params: SirenParams, m_state: SirenParams, v_state: SirenParams,
            x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, lr: float, step: int,
            mspec: ModelSpec, dim_out: int, loss_out: torch.Tensor | None, E: int | None,
            mm_dtype=None, corrections=None):
    """Check shapes and launch csrc/fused_step.cu once: one network
    (`E=None`: unstacked leaves, x (B, F), mask (B,), 0-d loss) or E experts
    (leaves with a leading E axis, x (E, B, F), mask (B,) shared or (E, B),
    (E,) loss).  `corrections` (c1, c2) replaces the bias corrections of
    `step` when given.  Returns the loss tensor.

    The first call with a leaf set binds a plan (`_bind`: every check);
    later calls that pass the same leaf objects (`is`) with the same x
    shape, mask rank, head width, spec, `mm_dtype` and current stream
    reuse it after checking only x, y, mask and loss (`_Plan.serves`).
    Anything else goes through `_bind` again, so a bad tensor raises the
    same ValueError on any call.  A bound leaf is trusted to stay the
    tensor it was, updated in place as the kernel and the training loops
    update it (never re-pointed by `.data =` or `set_`)."""
    lib = _kernel_lib()
    leaves = params.leaves() + m_state.leaves() + v_state.leaves()
    key = (x.shape, mask.dim(), dim_out, mspec, mm_dtype, _raw_stream(x.device))
    plan = _plans.get(E is None)
    if plan is None or not plan.serves(key, leaves, x, y, mask, loss_out):
        plan = _bind(params, m_state, v_state, x, y, mask, mspec, dim_out, loss_out, E, mm_dtype,
                     leaves, key)
    if loss_out is None:
        loss_out = torch.empty(plan.lead, dtype=torch.float32, device=x.device)
    c1, c2 = corrections or bias_corrections(step)
    rc = lib.lbdrn_fused_step(
        plan.argp, plan.n_exp, x.data_ptr(), y.data_ptr(), mask.data_ptr(), plan.mask_stride,
        plan.scratch_ptr, plan.n_cta, plan.S, plan.smem, loss_out.data_ptr(),
        float(np.float32(lr)), c1, c2, key[-1],
    )
    if rc != 0:
        raise RuntimeError(f"fused_step kernel launch failed: CUDA error {rc}")
    return loss_out


def _launch_multi(params: SirenParams, m_state: SirenParams, v_state: SirenParams,
                  X: torch.Tensor, Y: torch.Tensor, masks: torch.Tensor,
                  lrs: Sequence[float], step0: int, mspec: ModelSpec, dim_out: int,
                  loss_out: torch.Tensor | None, E: int | None, mm_dtype=None):
    """Check shapes and launch the multi-step kernel once, for k steps: one
    network (`E=None`: X (k, B, F), (k,) losses) or E experts (X (k, E, B,
    F) step-major, (k, E) losses); masks (k, B), shared by the experts.
    Returns (losses, CTAs in the cooperative grid)."""
    lib = _kernel_lib()
    lead = () if E is None else (E,)
    k = X.shape[0]
    B, F = X.shape[-2:]
    dev = X.device
    if k < 1 or len(lrs) != k:
        raise ValueError(f"{len(lrs)} learning rates for {k} steps")
    _check(X, (k, *lead, B, F), "X", dev)
    _check(Y, (k, *lead, B, dim_out), "Y", dev)
    _check(masks, (k, B), "masks", dev)
    args, smem, n_tiles, P = _step_args(params, m_state, v_state, B, F, mspec, dim_out, lead,
                                        dev, mm_dtype)
    if loss_out is None:
        loss_out = torch.empty((k, *lead), dtype=torch.float32, device=dev)
    else:
        _check(loss_out, (k, *lead), "loss_out", dev)

    # per-step lr, c1, c2 in float32, as `fused_train_step` computes them;
    # a fresh pinned buffer per launch (the host allocator keeps it until
    # the copy has run), so nothing syncs
    host = torch.empty((k, 3), dtype=torch.float32, pin_memory=True)
    table = host.numpy()
    for s, lr in enumerate(lrs):
        table[s] = (np.float32(lr), *bias_corrections(step0 + s))
    sched = host.to(dev, non_blocking=True)
    n_exp = 1 if E is None else E
    S = scratch_stride(P)
    scratch = torch.empty((n_exp, n_tiles, S), dtype=torch.float32, device=dev)
    barrier = torch.zeros(2, dtype=torch.int32, device=dev)
    grid = ctypes.c_int(0)
    rc = lib.lbdrn_fused_multi_step(
        ctypes.byref(args), n_exp, k,
        X.data_ptr(), B * F, n_exp * B * F,
        Y.data_ptr(), B * dim_out, n_exp * B * dim_out,
        masks.data_ptr(), 0, B,
        scratch.data_ptr(), n_tiles, S, smem, sched.data_ptr(), loss_out.data_ptr(),
        barrier.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(grid),
    )
    if rc != 0:
        raise RuntimeError(f"fused multi-step kernel launch failed: CUDA error {rc}")
    return loss_out, grid.value


def fused_train_step(params: SirenParams, m_state: SirenParams, v_state: SirenParams,
                     x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                     lr: float, step: int, mspec: ModelSpec, dim_out: int,
                     loss_out: torch.Tensor | None = None, mm_dtype=None,
                     corrections=None):
    """One fused training step, in place on params, m_state and v_state.

    x: (B, padded_in) f32; y: (B, dim_out) f32; mask: (B,) f32; `lr` and the
    1-indexed Adam `step` are host numbers (the bias corrections are
    computed here in float32, so nothing syncs).  Any B: the kernel masks
    its last CTA's rows.  `loss_out`: optional 0-d f32 tensor the loss is
    written into (the training loop passes a slot of its loss buffer).
    `mm_dtype`: None or "bfloat16" (see the module docstring).
    `corrections`: (c1, c2) in place of the bias corrections of `step` (the
    step-anatomy probes of profiling/kernel_prof.py run with (1, 1)).
    Returns (params, m_state, v_state, loss).

    CUDA tensors launch the kernel of csrc/fused_step.cu (raising if it
    cannot build or launch); CPU tensors take `fused_train_step_plain`.
    """
    if x.device.type == "cpu":
        return fused_train_step_plain(params, m_state, v_state, x, y, mask,
                                      lr, step, mspec, dim_out, loss_out, mm_dtype,
                                      corrections)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    loss_out = _launch(params, m_state, v_state, x, y, mask, lr, step, mspec, dim_out,
                       loss_out, None, mm_dtype, corrections)
    fused_train_step.launches += 1
    return params, m_state, v_state, loss_out


fused_train_step.launches = 0
fused_train_step.binds = 0  # plans bound (`_bind`): one a fit's leaf set


def fused_expert_step_plain(params, m_state, v_state, x, y, mask, lr, step,
                            mspec: ModelSpec, dim_out: int, loss_out=None, mm_dtype=None):
    """K2's function in plain torch ops: `fused_train_step_plain` on each
    expert's slices in turn (in place on the stacks).  mask: (B,) shared or
    (E, B).  Returns (params, m, v, loss (E,))."""
    E = x.shape[0]
    if loss_out is None:
        loss_out = torch.empty((E,), dtype=torch.float32, device=x.device)
    for e in range(E):
        fused_train_step_plain(
            unstack_params(params, e), unstack_params(m_state, e),
            unstack_params(v_state, e), x[e], y[e],
            mask[e] if mask.dim() == 2 else mask, lr, step, mspec, dim_out,
            loss_out=loss_out[e], mm_dtype=mm_dtype,
        )
    return params, m_state, v_state, loss_out


def fused_expert_step(params: SirenParams, m_state: SirenParams, v_state: SirenParams,
                      x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                      lr: float, step: int, mspec: ModelSpec, dim_out: int,
                      loss_out: torch.Tensor | None = None, mm_dtype=None):
    """One fused training step of E independent experts, in place.

    params/m/v leaves carry a leading expert axis (weights (E, in, out),
    biases (E, out)), contiguous; x: (E, B, padded_in); y: (E, B, dim_out);
    mask: (B,) shared or (E, B) per expert.  lr and the Adam step are
    shared; each expert's loss is scaled by its own mask count.
    `loss_out`: optional (E,) f32 tensor the losses are written into;
    `mm_dtype` as for `fused_train_step`.  Returns (params, m_state,
    v_state, loss (E,)).

    CUDA tensors launch csrc/fused_step.cu with an expert grid axis (one
    launch pair for all experts; raising if it cannot build or launch); CPU
    tensors take `fused_expert_step_plain`.
    """
    if x.device.type == "cpu":
        return fused_expert_step_plain(params, m_state, v_state, x, y, mask,
                                       lr, step, mspec, dim_out, loss_out, mm_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    loss_out = _launch(params, m_state, v_state, x, y, mask, lr, step, mspec, dim_out,
                       loss_out, x.shape[0], mm_dtype)
    fused_expert_step.launches += 1
    return params, m_state, v_state, loss_out


fused_expert_step.launches = 0
fused_expert_step.binds = 0


def fused_multi_step_plain(params, m_state, v_state, X, Y, masks, lrs, step0,
                           mspec: ModelSpec, dim_out: int, loss_out=None, mm_dtype=None):
    """K3's function in plain torch ops: k chained `fused_train_step_plain`
    calls, step s at Adam step step0 + s with lrs[s] (in place).  Returns
    (params, m, v, losses (k,))."""
    if loss_out is None:
        loss_out = torch.empty((X.shape[0],), dtype=torch.float32, device=X.device)
    for s, lr in enumerate(lrs):
        fused_train_step_plain(params, m_state, v_state, X[s], Y[s], masks[s], lr, step0 + s,
                               mspec, dim_out, loss_out=loss_out[s], mm_dtype=mm_dtype)
    return params, m_state, v_state, loss_out


def fused_multi_step(params: SirenParams, m_state: SirenParams, v_state: SirenParams,
                     X: torch.Tensor, Y: torch.Tensor, masks: torch.Tensor,
                     lrs: Sequence[float], step0: int, mspec: ModelSpec, dim_out: int,
                     loss_out: torch.Tensor | None = None, mm_dtype=None):
    """k sequential fused training steps in one launch, in place.

    X: (k, B, padded_in) f32; Y: (k, B, dim_out) f32; masks: (k, B) f32;
    `lrs`: the k learning rates, host numbers; `step0`: the 1-indexed Adam
    step of the first step (each step's bias corrections are computed on
    the host in float32, as `fused_train_step` computes them).  `loss_out`:
    optional (k,) f32 tensor the losses are written into; `mm_dtype` as for
    `fused_train_step`.  Returns (params, m_state, v_state, losses (k,)).

    The function of k `fused_train_step` calls, and on the card
    bit-identical to them.  CUDA tensors launch the persistent cooperative
    kernel of csrc/fused_step.cu once (raising if it cannot build or
    launch; it never falls back to per-step launches); CPU tensors take
    `fused_multi_step_plain`.  Any B: unlike the TPU kernel, which needs
    the whole batch in one VMEM tile, the card's kernel tiles the batch.
    """
    if X.device.type == "cpu":
        return fused_multi_step_plain(params, m_state, v_state, X, Y, masks, lrs, step0,
                                      mspec, dim_out, loss_out, mm_dtype)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    loss_out, fused_multi_step.grid = _launch_multi(
        params, m_state, v_state, X, Y, masks, lrs, step0, mspec, dim_out, loss_out, None,
        mm_dtype)
    fused_multi_step.launches += 1
    return params, m_state, v_state, loss_out


fused_multi_step.launches = 0
fused_multi_step.grid = 0  # CTAs in the last launch's cooperative grid


def fused_expert_multi_step_plain(params, m_state, v_state, X, Y, masks, lrs, step0,
                                  mspec: ModelSpec, dim_out: int, loss_out=None,
                                  mm_dtype=None):
    """K4's function in plain torch ops: k chained `fused_expert_step_plain`
    calls with the step's (B,) mask shared by the experts (in place).
    Returns (params, m, v, losses (k, E))."""
    if loss_out is None:
        loss_out = torch.empty(X.shape[:2], dtype=torch.float32, device=X.device)
    for s, lr in enumerate(lrs):
        fused_expert_step_plain(params, m_state, v_state, X[s], Y[s], masks[s], lr, step0 + s,
                                mspec, dim_out, loss_out=loss_out[s], mm_dtype=mm_dtype)
    return params, m_state, v_state, loss_out


def fused_expert_multi_step(params: SirenParams, m_state: SirenParams, v_state: SirenParams,
                            X: torch.Tensor, Y: torch.Tensor, masks: torch.Tensor,
                            lrs: Sequence[float], step0: int, mspec: ModelSpec,
                            dim_out: int, loss_out: torch.Tensor | None = None,
                            mm_dtype=None):
    """k sequential fused steps of E independent experts in one launch.

    params/m/v leaves carry a leading expert axis, as for
    `fused_expert_step`; X: (k, E, B, padded_in) step-major (the JAX
    kernel's layout); Y: (k, E, B, dim_out); masks: (k, B), step s's mask
    shared by every expert; lrs, step0 as for `fused_multi_step`.
    `loss_out`: optional (k, E) f32 tensor (step-major, where the JAX kernel
    returns (E, k)); `mm_dtype` as for `fused_train_step`.  Returns
    (params, m_state, v_state, losses (k, E)).

    The function of k `fused_expert_step` calls, and on the card
    bit-identical to them; expert e is `fused_multi_step` on its slices.
    CUDA tensors launch the kernel of `fused_multi_step` with an expert
    axis (once; raising if it cannot build or launch); CPU tensors take
    `fused_expert_multi_step_plain`.
    """
    if X.device.type == "cpu":
        return fused_expert_multi_step_plain(params, m_state, v_state, X, Y, masks, lrs,
                                             step0, mspec, dim_out, loss_out, mm_dtype)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    loss_out, fused_expert_multi_step.grid = _launch_multi(
        params, m_state, v_state, X, Y, masks, lrs, step0, mspec, dim_out, loss_out,
        X.shape[1], mm_dtype)
    fused_expert_multi_step.launches += 1
    return params, m_state, v_state, loss_out


fused_expert_multi_step.launches = 0
fused_expert_multi_step.grid = 0


def _eval_region(x: torch.Tensor, y: torch.Tensor, W: int, skip: int, rows, cols):
    """(R, C, rows, cols) of one eval block, checked: x (R * W, F) and y
    (R * W, C); live image rows skip .. rows - 1 (default R), columns below
    cols (default W)."""
    n, C = y.shape
    if x.dim() != 2 or x.shape[0] != n or W < 1 or n % W:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} are not one block of "
                         f"image rows of width {W}")
    R = n // W
    rows = R if rows is None else rows
    cols = W if cols is None else cols
    if not (0 <= skip and rows <= R and 0 < cols <= W):
        raise ValueError(f"live rows {skip}..{rows} and columns <{cols} outside a {R} x {W} block")
    return R, C, rows, cols


def fused_eval_sse_plain(params: SirenParams, x: torch.Tensor, y: torch.Tensor,
                         mspec: ModelSpec, W: int, skip: int = 0, rows: int | None = None,
                         cols: int | None = None, out: torch.Tensor | None = None,
                         dim_in: int | None = None, fast_act: bool = True) -> torch.Tensor:
    """K6's function in plain torch ops, in the block path's own order
    (`forward(fast_act=fast_act)`, the squared error, one sum of the live
    region): arguments as `fused_eval_sse`.  `dim_in` is not used: the
    padding columns add exact zeros.  `fast_act=False`: the exact eval
    (torch.sin), `train/loop.py::blocks_mse`'s path on any device."""
    R, C, rows, cols = _eval_region(x, y, W, skip, rows, cols)
    err = (forward(params, x, mspec, fast_act=fast_act) - y) ** 2
    if rows == R and cols == W:
        sse = err[skip * W :].sum()
    else:
        sse = err.view(R, W, C)[skip:rows, :cols].sum()
    if out is None:
        return sse
    return out.add_(sse)


_eval_cache: dict = {}  # (StepArgs, tile rows, shared memory, resident CTAs) per network


def _launch_eval(params: SirenParams, x: torch.Tensor, y: torch.Tensor, mspec: ModelSpec,
                 W: int, skip: int, rows: int, cols: int, out: torch.Tensor,
                 dim_in: int | None):
    """Check shapes and launch K6 once over the live rows skip * W ..
    rows * W - 1 of the block (none: no launch).  Returns True if it
    launched."""
    lib = _kernel_lib()
    dev = x.device
    n, F = x.shape
    C = y.shape[1]
    L = len(params.weights)
    if L > MAX_LAYERS or L != mspec.num_layers + 1:
        raise ValueError(f"unsupported layer count {L}")
    dims = [F] + [w.shape[-1] for w in params.weights]
    if dims[-1] != C:
        raise ValueError(f"head width {dims[-1]} != label width {C}")
    _check(x, (n, F), "x", dev)
    _check(y, (n, C), "y", dev)
    _check(out, (), "out", dev)
    for l in range(L):
        _check(params.weights[l], (dims[l], dims[l + 1]), ("weight", l), dev)
        _check(params.biases[l], (dims[l + 1],), ("bias", l), dev)
    lo, hi = skip * W, rows * W
    if hi <= lo:
        return False
    k0 = F if dim_in is None else min(F, _r4(dim_in))
    key = (tuple(t.data_ptr() for t in params.leaves()), tuple(dims), k0, mspec)
    hit = _eval_cache.get(key)
    if hit is None:
        live = [k0] + dims[1:]
        T, stage_w = cta_layout(live, _smem_optin, eval_smem_bytes, EVAL_ROWS)
        smem = eval_smem_bytes(live, T, stage_w)
        ctas = lib.lbdrn_eval_ctas(int(stage_w), smem)
        if ctas <= 0:
            raise RuntimeError(f"fused_eval_sse: no CTA of {smem} B fits (CUDA error {-ctas})")
        args = _StepArgs()
        for l in range(L):
            args.w[l] = params.weights[l].data_ptr()
            args.b[l] = params.biases[l].data_ptr()
        for l, d in enumerate(live):
            args.dims[l] = d
        for l, w0 in enumerate(layer_w0s(mspec)):
            args.w0[l] = w0
        args.L, args.rows, args.stage_w = L, T, int(stage_w)
        hit = (args, T, smem, ctas)
        if len(_eval_cache) > 64:
            _eval_cache.clear()
        _eval_cache[key] = hit
    args, T, smem, ctas = hit
    grid = min(-(-(hi - lo) // T), ctas)
    partials = torch.empty((grid,), dtype=torch.float32, device=dev)
    rc = lib.lbdrn_fused_eval_sse(
        ctypes.byref(args), x.data_ptr(), F, y.data_ptr(), W, lo, hi - lo, cols,
        partials.data_ptr(), grid, smem, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused_eval_sse kernel launch failed: CUDA error {rc}")
    return True


def fused_eval_sse(params: SirenParams, x: torch.Tensor, y: torch.Tensor, mspec: ModelSpec,
                   W: int, skip: int = 0, rows: int | None = None, cols: int | None = None,
                   out: torch.Tensor | None = None, dim_in: int | None = None) -> torch.Tensor:
    """Add the masked SSE of one row block of the fast-act eval into `out`.

    x: (R * W, F) f32 inputs of R image rows of width W, y: (R * W, C) f32
    labels, both contiguous; params in the port's layout (weights (in, out),
    biases (out,)).  The error of an output is (sigmoid head - y)^2 after
    hidden sin(w0 z) by `sincos`, as `forward(fast_act=True)` gives it,
    always in f32.  Live: image rows skip .. rows - 1 of the block (default
    R), columns below `cols` (default W).  `out`: a 0-d f32 tensor (default
    a new zero).  `dim_in`: the live input width; the kernel leaves out x's
    columns past it and W0's rows there, which are zero padding.  Returns
    out.

    CUDA tensors launch K6 of csrc/fused_step.cu (raising if it cannot build
    or launch; it never falls back); CPU tensors take
    `fused_eval_sse_plain`.
    """
    if out is None:
        out = torch.zeros((), dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return fused_eval_sse_plain(params, x, y, mspec, W, skip, rows, cols, out, dim_in)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _, _, rows, cols = _eval_region(x, y, W, skip, rows, cols)
    if _launch_eval(params, x, y, mspec, W, skip, rows, cols, out, dim_in):
        fused_eval_sse.launches += 1
    return out


fused_eval_sse.launches = 0


def reference_train_step(params, m_state, v_state, x, y, mask, lr, step,
                         mspec: ModelSpec, dim_out: int, match_kernel: bool = False,
                         loss_out=None, mm_dtype=None):
    """The oracle step, in place on params/m/v.  By default exact
    `torch.sin` + autograd in f32, whatever `mm_dtype` (as the JAX oracle);
    `match_kernel=True` replays the kernel's numerics (shared-reduction
    sincos, the hand-derived backward, the `mm_dtype` casts)."""
    if match_kernel:
        return fused_train_step_plain(params, m_state, v_state, x, y, mask,
                                      lr, step, mspec, dim_out, loss_out, mm_dtype)
    leaves = [t.detach().requires_grad_(True) for t in params.leaves()]
    L = len(params.weights)
    p = SirenParams(leaves[:L], leaves[L:])
    with torch.enable_grad():
        pred = forward(p, x, mspec)
        se = ((pred - y) ** 2 * mask[:, None]).sum()
        loss = se / (torch.clamp(mask.sum(), min=1.0) * dim_out)
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        _apply_adam(params, m_state, v_state, grads[:L], grads[L:], lr, step)
        loss = loss.detach()
        if loss_out is not None:
            loss_out.copy_(loss)
            loss = loss_out
    return params, m_state, v_state, loss
