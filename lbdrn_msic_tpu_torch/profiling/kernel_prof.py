"""Fused-step anatomy on the card (K5): which part costs the step time?

The counterpart of scripts/profiling/kernel_prof.py.  Variants of the fused
forward/backward/Adam step, each run as a 512-step loop on one fixed
(8192, 128) batch (bc=64, nl=2, C=4: the bench config), lr 1e-3, Adam with
c1 = c2 = 1 every step, a mask of ones.  The kernels of csrc/kernel_prof.cu
scale loss and gradients by 1/(B*C) whatever the mask, as the JAX probe
does; prod_* go through K1, which scales by 1/(max(sum mask, 1)*C), the
same for a mask of ones:

  prod_f32      K1 itself (csrc/fused_step.cu), shared-reduction sincos, f32
  prod_bf16     K1 with mm_dtype "bfloat16"
  full_t        exact sin forward, cos backward, f32 products; the
                backward's W^T staged in shared memory
  full_dg       the same function reading W in place (the TPU's dot_general)
  fast_full     full_t with the 2pi-period polynomial sin/cos
  prec_default  the TPU's one-pass reduced-precision product: one-pass TF32
                on the tensor cores here
  prec_high     the TPU's three-pass product: 3xTF32 here
  fwd_notrans   products only: identity activations, linear head, the
                unscaled SSE as the loss, params unchanged
  tile2048      full_dg at a quarter of the rows per CTA (the JAX variant is
                at a quarter of the batch per grid step): same function

    python -m lbdrn_msic_tpu_torch.profiling.kernel_prof [variant ...]

prints `label: ms (us/step)` per variant, timed with CUDA events (best of
three 512-step runs, device time, as the JAX script prints; `profile`
returns every run's time).  Every variant but prod_* is a kernel of
csrc/kernel_prof.cu (`variant_step`, its launches counted per variant in
`variant_step.launches`); prod_* launch K1 (counted on
`fused_train_step.launches`).  `variant_step_plain` is each variant's
function in plain torch ops: the CPU takes it, and on the card it exists to
be compared with.  The JAX script's `mode == "fwd"` branch
(kernel_prof.py:155) is reachable from none of its variants and is not
carried over.
"""

from __future__ import annotations

import ctypes
import math
import sys

import numpy as np
import torch

from lbdrn_msic_tpu_torch import resolve_device
from lbdrn_msic_tpu_torch.core.config import ModelSpec
from lbdrn_msic_tpu_torch.models.siren import SirenParams
from lbdrn_msic_tpu_torch.ops import fused_step as fs

B, F, BC, C = 8192, 128, 64, 4
LR = 1e-3
STEPS = 512

# name -> (mode, use_dg, tile), the JAX script's table (kernel_prof.py:302-312):
# tile is the batch rows per TPU grid step at B; here it sets the rows per
# CTA (fs.ROWS * tile / B)
VARIANTS = {
    "prod_f32": ("prod_f32", False, B),
    "prod_bf16": ("prod_bf16", False, B),
    "full_t": ("full", False, B),
    "full_dg": ("full", True, B),
    "fast_full": ("fast_full", False, B),
    "prec_default": ("prec_default", False, B),
    "prec_high": ("prec_high", False, B),
    "fwd_notrans": ("fwd_notrans", False, B),
    "tile2048": ("full", True, 2048),
}
# (mode, use_dg) -> kernel id of csrc/kernel_prof.cu (prod_* are K1)
_KERNEL_IDS = {("full", False): 0, ("full", True): 1, ("fast_full", False): 2,
               ("prec_default", False): 3, ("prec_high", False): 4,
               ("fwd_notrans", False): 5}
KERNEL_VARIANTS = [v for v, (mode, _, _) in VARIANTS.items() if not mode.startswith("prod")]
# the product of each mode: f32 unless listed
PRODUCT = {"prec_default": "tf32", "prec_high": "3xtf32", "prod_bf16": "bf16"}

_f32 = lambda v: float(np.float32(v))
_INV2PI = _f32(0.15915494309189535)
_HALF_PI = _f32(math.pi / 2)
_SIN_C = tuple(map(_f32, (6.283183466e+00, -4.134148036e+01, 8.159765788e+01,
                          -7.659492822e+01, 4.126992957e+01, -1.237249482e+01)))


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """The 2pi-period polynomial sin of kernel_prof.py:41-48."""
    t = x * _INV2PI
    t = t - torch.round(t)
    t2 = t * t
    p = torch.full_like(x, _SIN_C[5])
    for k in (4, 3, 2, 1, 0):
        p = p * t2 + _SIN_C[k]
    return t * p


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    return fast_sin(x + _HALF_PI)


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 (10 mantissa bits, ties away from zero), as the
    kernel's cvt.rna.tf32.f32 rounds each tensor-core operand."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _dot(a: torch.Tensor, b: torch.Tensor, product: str) -> torch.Tensor:
    """a @ b with the product of a variant: f32; one-pass TF32 (rounded
    operands, exact products, f32 sums); 3xTF32 (big and small TF32 parts,
    small terms first)."""
    if product == "tf32":
        return torch.matmul(tf32_round(a), tf32_round(b))
    if product == "3xtf32":
        ab, bb = tf32_round(a), tf32_round(b)
        a_s, b_s = tf32_round(a - ab), tf32_round(b - bb)
        return (torch.matmul(a_s, bb) + torch.matmul(ab, b_s)) + torch.matmul(ab, bb)
    return torch.matmul(a, b)


def variant_step_plain(params: SirenParams, m_state: SirenParams, v_state: SirenParams,
                       x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, variant: str,
                       mspec: ModelSpec | None = None, lr: float = LR, loss_out=None):
    """One step of `variant` in plain torch ops, in place on params, m and v
    (the forward-only variant leaves them as they are).  x (B, F), y (B, C),
    mask (B,).  Returns the loss (0-d)."""
    mode, _, _ = VARIANTS[variant]
    mspec = mspec or ModelSpec()
    if mode.startswith("prod"):
        *_, loss = fs.fused_train_step_plain(
            params, m_state, v_state, x, y, mask, lr, 1, mspec, y.shape[1], loss_out,
            "bfloat16" if mode == "prod_bf16" else None, (1.0, 1.0))
        return loss
    dot = lambda a, b: _dot(a, b, PRODUCT.get(mode, "f32"))
    sin_fn, cos_fn = (fast_sin, fast_cos) if mode == "fast_full" else (torch.sin, torch.cos)
    fwd_only = mode == "fwd_notrans"
    w0s = fs.layer_w0s(mspec)
    ws, bs = params.weights, [b.reshape(1, -1) for b in params.biases]
    L = len(ws)
    zs, h = [], x
    for l in range(L - 1):
        z = dot(h, ws[l]) + bs[l]
        zs.append(z)
        h = z if fwd_only else sin_fn(w0s[l] * z)
        zs.append(h)
    z_last = dot(h, ws[L - 1]) + bs[L - 1]
    p = z_last if fwd_only else 1.0 / (1.0 + torch.exp(-z_last))
    diff = (p - y) * mask.reshape(-1, 1)
    sse = torch.sum(diff * diff)
    inv = _f32(1.0 / (x.shape[0] * y.shape[1]))
    if fwd_only:
        loss = sse
    else:
        g = 2.0 * diff * (p * (1.0 - p))
        dws, dbs = [None] * L, [None] * L
        dws[L - 1] = dot(zs[2 * (L - 2) + 1].T, g)
        dbs[L - 1] = torch.sum(g, dim=0)
        for l in range(L - 2, -1, -1):
            g = dot(g, ws[l + 1].T)
            g = g * (w0s[l] * cos_fn(w0s[l] * zs[2 * l]))
            dws[l] = dot((zs[2 * l - 1] if l > 0 else x).T, g)
            dbs[l] = torch.sum(g, dim=0)
        fs._apply_adam(params, m_state, v_state, [d * inv for d in dws],
                       [d * inv for d in dbs], lr, None, (1.0, 1.0))
        loss = sse * inv
    if loss_out is not None:
        loss_out.copy_(loss)
        return loss_out
    return loss


def smem_bytes(dims, rows: int, stage_wt: bool) -> int:
    """Dynamic shared memory of a probe's first pass: K1's with the weights
    staged, plus W^T of layers 1.. when staged (the kernel's carve-up)."""
    wt = sum(dims[l] * dims[l + 1] for l in range(1, len(dims) - 1))
    return fs.smem_bytes(dims, rows, True) + (4 * wt if stage_wt else 0)


def cta_rows(variant: str) -> int:
    """Batch rows per CTA: K1's, times the JAX variant's tile / B."""
    return max(8, fs.ROWS * VARIANTS[variant][2] // B)


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from lbdrn_msic_tpu_torch.ops._build import load

        lib = load("kernel_prof")
        lib.lbdrn_kprof_step.restype = ctypes.c_int
        lib.lbdrn_kprof_step.argtypes = [
            ctypes.POINTER(fs._StepArgs), ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


def _launch(params, m_state, v_state, x, y, mask, variant, mspec, lr, loss_out):
    """Check shapes and launch csrc/kernel_prof.cu once for `variant`."""
    lib = _kernel_lib()
    fs._kernel_lib()  # K1's library reads the device's shared-memory limit (fs._smem_optin)
    mode, use_dg, _ = VARIANTS[variant]
    Bx, Fx = x.shape
    Cx = y.shape[1]
    dev = x.device
    fs._check(x, (Bx, Fx), "x", dev)
    fs._check(y, (Bx, Cx), "y", dev)
    fs._check(mask, (Bx,), "mask", dev)
    # K1's cached StepArgs (pointers, widths) with this variant's rows
    k1_args, _, _, P = fs._step_args(params, m_state, v_state, Bx, Fx, mspec, Cx, (), dev)
    args = fs._StepArgs.from_buffer_copy(k1_args)
    args.rows = cta_rows(variant)
    dims = [Fx] + [w.shape[1] for w in params.weights]
    smem = smem_bytes(dims, args.rows, mode != "fwd_notrans" and not use_dg)
    if smem > fs._smem_optin:
        raise ValueError(f"widths {dims} need {smem} B of shared memory at {args.rows} rows; "
                         f"the device allows {fs._smem_optin}")
    n_cta = -(-Bx // args.rows)
    if loss_out is None:
        loss_out = torch.empty((), dtype=torch.float32, device=dev)
    else:
        fs._check(loss_out, (), "loss_out", dev)
    scratch = torch.empty((n_cta, P + 2), dtype=torch.float32, device=dev)
    rc = lib.lbdrn_kprof_step(
        ctypes.byref(args), _KERNEL_IDS[mode, use_dg], x.data_ptr(), y.data_ptr(),
        mask.data_ptr(), scratch.data_ptr(), n_cta, smem, loss_out.data_ptr(),
        _f32(lr), 1.0, 1.0, _f32(1.0 / (Bx * Cx)), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kernel_prof kernel launch failed: CUDA error {rc}")
    return loss_out


def variant_step(params: SirenParams, m_state: SirenParams, v_state: SirenParams,
                 x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, variant: str,
                 mspec: ModelSpec | None = None, lr: float = LR, loss_out=None):
    """One step of `variant`, in place on params, m and v; returns the loss.

    prod_f32 / prod_bf16 call `fused_train_step` (K1; mm_dtype None /
    "bfloat16", c1 = c2 = 1).  Every other variant: for CUDA tensors one
    launch of csrc/kernel_prof.cu (raising if it cannot build or launch),
    counted in `variant_step.launches[variant]`; for CPU tensors
    `variant_step_plain`."""
    mode, _, _ = VARIANTS[variant]
    mspec = mspec or ModelSpec()
    if mode.startswith("prod"):
        *_, loss = fs.fused_train_step(
            params, m_state, v_state, x, y, mask, lr, 1, mspec, y.shape[1], loss_out,
            "bfloat16" if mode == "prod_bf16" else None, (1.0, 1.0))
        return loss
    if x.device.type == "cpu":
        return variant_step_plain(params, m_state, v_state, x, y, mask, variant, mspec, lr,
                                  loss_out)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    loss = _launch(params, m_state, v_state, x, y, mask, variant, mspec, lr, loss_out)
    variant_step.launches[variant] += 1
    return loss


variant_step.launches = dict.fromkeys(KERNEL_VARIANTS, 0)


def run_steps(ws, bs, x, y, mask, variant: str, steps: int = STEPS,
              mspec: ModelSpec | None = None, device=None):
    """`steps` steps of `variant` on one fixed batch, from params (ws, bs;
    JAX layout, biases (out,) or (1, out)) and zero Adam state, as the JAX
    `run_steps` scans 512.  mask: B values (the JAX (B, 1) is taken too).
    Returns (the sum of the losses, the (steps,) losses), on `device`
    (default CUDA)."""
    dev = resolve_device(device)
    params = SirenParams([w.to(dev, torch.float32).clone() for w in ws],
                         [b.to(dev, torch.float32).reshape(-1).clone() for b in bs])
    m_state, v_state = params.map(torch.zeros_like), params.map(torch.zeros_like)
    x, y = x.to(dev, torch.float32).contiguous(), y.to(dev, torch.float32).contiguous()
    mask = mask.to(dev, torch.float32).reshape(-1).contiguous()
    losses = torch.empty((steps,), dtype=torch.float32, device=dev)
    for s in range(steps):
        variant_step(params, m_state, v_state, x, y, mask, variant, mspec, loss_out=losses[s])
    return losses.sum(), losses


def make_inputs(seed: int = 0, batch: int = B, device=None):
    """The JAX script's inputs (kernel_prof.py:274-289) in shape and scale,
    drawn from a torch.Generator: weights N(0, 1) * 0.05 (F x BC, BC x BC,
    BC x C), zero biases, x ~ U(-1, 1) (batch, F), y ~ U(0, 1) (batch, C),
    a mask of ones.  Returns (ws, bs, x, y, mask) on `device` (default
    CUDA)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    ws = [torch.randn(shape, generator=gen) * 0.05 for shape in ((F, BC), (BC, BC), (BC, C))]
    bs = [torch.zeros(BC), torch.zeros(BC), torch.zeros(C)]
    x = torch.rand((batch, F), generator=gen) * 2 - 1
    y = torch.rand((batch, C), generator=gen)
    mask = torch.ones(batch)
    return ([w.to(dev) for w in ws], [b.to(dev) for b in bs], x.to(dev), y.to(dev),
            mask.to(dev))


def run_ms(ws, bs, x, y, mask, variant: str, steps: int = STEPS) -> float:
    """Device milliseconds of one `run_steps` on the card: CUDA events
    around it, queued behind a GPU sleep (~0.1 s) so that the host's
    per-step enqueue does not pace the device."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start.record()
    run_steps(ws, bs, x, y, mask, variant, steps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def profile(names, rounds: int = 3, inputs=None) -> dict:
    """{variant: [device ms of each of `rounds` 512-step runs]} on `inputs`
    (default `make_inputs()`), printing the JAX script's line (the best
    run) for each."""
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; choose from {list(VARIANTS)}")
    ws, bs, x, y, mask = inputs or make_inputs()
    out = {}
    for name in names:
        out[name] = [run_ms(ws, bs, x, y, mask, name) for _ in range(rounds)]
        best = min(out[name])
        print(f"{name:>12}: {best:8.1f} ms ({best / STEPS * 1e3:6.1f} us/step)", flush=True)
    return out


def main(argv=None) -> int:
    profile(list(sys.argv[1:] if argv is None else argv) or list(VARIANTS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
