"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py              # every phase (needs one CUDA card)
    python3 chip_smoke.py --only kernels
    python3 chip_smoke.py --profile    # adds torch.profiler breakdowns of
                                       # one encode, one sweep, the fit at
                                       # multi_k 0 and 16, and one epoch of
                                       # the GF-2 "full" / "banded" encodes

Phases, one JSON line each (every phase asserts; nothing is caught):
  env      card name and power limit, TF32 switched off
  build    nvcc build of csrc/fused_step.cu and g++ build of the host codecs
  kernels  K1, the fused-step kernel, against its plain PyTorch version at
           the bench shape (B=8192, 128->64->64->4), full and ragged/masked
           batches, and at a wider layer set (bc=128, nl=3, C=8); a 5-step
           chain against the exact autograd oracle; the kernel's CUDA-event
           time beside its bound and the plain time; each pass's device
           time by kernel name (a torch.profiler window over 50 steps; pass
           2 is a programmatic dependent launch whose span opens during pass
           1, so the line also gives the step's time less pass 1's); the
           design csrc/fused_step.cu fixes (no clusters, FFMA products)
  kernels_experts  K2, the expert step (same source, an expert grid axis),
           at the sweep's shape (E=4, B=8192): against its plain version,
           and bit for bit against K1 on each expert's slices, full,
           ragged with per-expert masks, and at the wider layer set; time,
           pass split and design as for K1, bound, plain time
  encode   2048x2048x4 12-bit synthetic scene, seed 42, K=5, g=8, e=10,
           base codec lpc: one warm and three timed encodes, each of which
           must launch K1 exactly epochs x steps = 5120 times (and K2 never)
  determinism  the timed encodes' streams are byte-identical
  decode   three timed decodes; MSBs exact; PSNR
  rd       fused-kernel encode vs exact-step (use_fused=False) encode of the
           same scene and seed: PSNR within 0.1 dB
  sweep    the rate sweep of the same scene, K in {3, 4, 5, 6}, "full" tap
           staging: one warm and three timed `encode_rate_points`, each of
           which must launch K2 exactly 5120 times (and K1 never); streams
           byte-identical across sweeps; each point decoded (MSBs exact)
           and held against `encode_image` at its K (PSNR within 0.1 dB)
  kernels_multi  K3 (k steps of K1 in one persistent cooperative launch)
           and K4 (of K2), same source: K3 at k=16, B=8192; ragged/masked
           with a schedule and step0=3; wide; K4 at E=4, k=8, full and
           wide.  Each step at K1's tolerances against the plain step from
           the same state, the whole chunk at trajectory tolerance against
           the plain k steps, every launch bit for bit k chained K1 / K2
           launches, K4's expert e bit for bit K3; time per launch and per
           step, k chained single-step launches, bound, plain time
  multi_k  `fit` (K=5) at multi_k in {0, 4, 16, 64} and `fit_rate_experts`
           (K in {3, 4, 5, 6}) at {0, 8, 32} on the same scene, the
           counterpart of scripts/profiling/multik_ab.py: one warm and two
           timed rounds, interleaved; exactly epochs x ceil(steps / k)
           K3 / K4 launches (0 single-step ones), or epochs x steps K1 / K2
           at multi_k=0; every chunked fit bit-identical to multi_k=0
  mm_dtype K1-K4 at mm_dtype "bfloat16" against their plain versions (bench
           shape; K1 also wide): one step's m and v within 1e-5 of the bf16
           plain step's and at least 10x farther from the f32 plain step's;
           K3 / K4 bit for bit chained K1 / K2 at bf16 (the first of those
           held as one step is) and within the JAX bf16 tier (2e-2); then the counterpart of scripts/profiling/mm_ab.py: `fit` at the
           bench config with mm_dtype None and "bfloat16", one warm and two
           timed rounds each, interleaved: seconds and best MSE
  staging  training above the feature-cache budget, one run each: (a) `fit`
           at the bench scene (e=2) in "full" and "banded" staging, bit for
           bit "cached" at g=8, and "gather" bit for bit "cached" at g=1;
           (b) a GF-2-sized scene (7605x7815x4, 12-bit, seed 42, e=10):
           `encode_image` at K=5 must pick "full" and at K=3 "banded", each
           launching K1 exactly 10 x 7256 = 72560 times (K2 never), decoded
           with MSBs exact; (c) its rate sweep, K in {3, 4, 5, 6}: "banded",
           one group, exactly 72560 K2 launches (K1 never), every point
           decoded with MSBs exact, K=3 byte-identical to (b)'s K=3 stream,
           K=5 within 0.1 dB of (b)'s "full" K=5.  Seconds, staged bytes
           against `_staging_bytes`' estimate, peak device memory, sha256;
           with --profile, one epoch of each GF-2 encode under the profiler
  kernel_prof  K5, the nine step-anatomy probes of
           profiling/kernel_prof.py: each variant's kernel against its plain
           version from the same state, one step and a 5-step chain, at a
           tolerance per product (f32, TF32, 3xTF32, bf16); fwd_notrans
           leaves params bit-unchanged, full_t is full_dg bit for bit,
           tile2048 agrees with full_dg to summation order; then the
           profiling path itself, variant by variant with the counts
           zeroed before it: three 512-step runs (median device time)
           beside the bound and the plain time, and the launches it made
Then the kernels line (K1-K4, K5 per variant), the card line, and the final
status line.  Exits non-zero without a result when CUDA is absent or the
package is missing.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import subprocess
import sys
import time


# thread-block cluster size and f32 product routine of csrc/fused_step.cu's
# first pass, fixed in the source (PERF.md has the times of the others)
FUSED_STEP_DESIGN = {"cluster": 1, "product": "ffma"}
# the device functions of K1-K4 (csrc/fused_step.cu), by kernel name
FUSED_STEP_KERNELS = ("step_partials", "step_adam", "multi_step")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, stdout=subprocess.PIPE, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def step_cost(B: int, dims, P: int):
    """(operations, bytes) one fused step needs: the matmuls (forward, dW,
    dH for layers >= 1), ~26 ops per hidden activation for sincos, ~12 per
    parameter for Adam; x/y/mask read once, params/m/v read and written."""
    L = len(dims) - 1
    mm = sum(dims[l] * dims[l + 1] for l in range(L))
    mm_dh = sum(dims[l] * dims[l + 1] for l in range(1, L))
    ops = 2 * B * (2 * mm + mm_dh) + 26 * B * sum(dims[1:L]) + 12 * P
    nbytes = 4 * (B * dims[0] + B * dims[-1] + B) + 4 * 6 * P + 4
    return ops, nbytes


def cuda_ms(fn, n: int, rounds: int = 3, warm: int = 10) -> float:
    """Device milliseconds per call: CUDA events around n back-to-back
    calls, median over rounds.  A GPU sleep queued first lets the host
    enqueue all n calls before the device reaches them, so host-side
    wrapper time does not leave gaps inside the timed window."""
    import numpy as np
    import torch

    for _ in range(warm):
        fn()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)  # ~0.1 s of device time
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / n)
    return float(np.median(per_call))


def pass_times(fn, n: int = 50) -> dict:
    """Device ms per call of each kernel that n calls of fn launch, by
    kernel name (a step's two passes), from a short torch.profiler window."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            name = re.sub(r"\(.*", "", ev.key.replace("(anonymous namespace)::", ""))
            out[name.replace("void ", "")] = {"ms_per_call": us / 1e3 / n,
                                              "launches_per_call": ev.count / n}
    return out


def pass1_ms(passes: dict) -> float:
    """Pass 1's device ms per step in a `pass_times` result.  Pass 2 is a
    programmatic dependent launch: its span opens while pass 1 runs, so
    what it adds to a step is the step's time less pass 1's."""
    return sum(v["ms_per_call"] for k, v in passes.items() if k.startswith("step_partials"))


def check_step(k_state, k_loss, p_state, p_loss, lr: float = 1e-3):
    """A kernel's step against its plain version's, from the same state, at
    the tolerances of tests/test_fused_step.py (only summation order
    differs).  Returns (max abs param difference, params with |g| < 1e-6)."""
    import torch

    from lbdrn_msic_tpu_torch.ops.fused_step import ADAM_B1

    (kp, km, kv), (pp, pm, pv) = k_state, p_state
    torch.testing.assert_close(k_loss, p_loss, rtol=1e-5, atol=0)
    for a, r in zip(km.leaves() + kv.leaves(), pm.leaves() + pv.leaves()):
        torch.testing.assert_close(a, r, rtol=1e-3, atol=1e-10)
    # params: the first Adam step moves each by ~lr*g/(|g|+eps), whose
    # sensitivity to g is lr*eps/(|g|+eps)^2 — ill-conditioned for
    # |g| < 1e-6, where a last-bit difference in the gradient sum moves
    # the param by up to 2*lr (bench.py's sign-flip bound).  Elements
    # with |g| >= 1e-6 are held to the tests' tolerance.
    n_ill, err = 0, 0.0
    for a, r, m in zip(kp.leaves(), pp.leaves(), pm.leaves()):
        well = (m.abs() / (1 - ADAM_B1)) >= 1e-6
        torch.testing.assert_close(a[well], r[well], rtol=2e-4, atol=1e-6)
        assert float((a - r).abs().max()) <= 2 * lr
        n_ill += int((~well).sum())
        err = max(err, float((a - r).abs().max()))
    return err, n_ill


def kernel_entry(name: str, replaces: str, card: str, ops, nbytes: float,
                 ms: float, plain_ms: float, max_err: float,
                 source: str = "lbdrn_msic_tpu_torch/csrc/fused_step.cu") -> dict:
    """One kernel's entry of the kernels line; `launches` is filled in by
    the main-path phase that drives it.  `ops`: f32 CUDA-core operations,
    or {unit: operations} with units of `profiling.PEAKS` ("f32", "tf32",
    "bf16"), each at its own peak (the units run side by side, so the
    slowest bounds)."""
    from lbdrn_msic_tpu_torch.profiling import peaks

    pk = peaks(card)
    ops = ops if isinstance(ops, dict) else {"f32": ops}
    t_ops = max(n / pk[unit] for unit, n in ops.items()) * 1e3
    t_bytes = nbytes / pk["hbm"] * 1e3
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        # no single PyTorch call computes a fused forward + backward + Adam step
        "library_ms": None,
    }


def phase_kernels(card: str):
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch.core.config import ModelSpec
    from lbdrn_msic_tpu_torch.models.siren import init_params, pad_dim
    from lbdrn_msic_tpu_torch.ops import fused_step as fs

    mspec = ModelSpec()
    C, dim_in, B = 4, 100, 8192
    F = pad_dim(dim_in)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def inputs(b, masked, c=C):
        x = np.zeros((b, F), np.float32)
        x[:, :dim_in] = rng.uniform(-1, 1, (b, dim_in))
        y = (1 / (1 + np.exp(-rng.standard_normal((b, c))))).astype(np.float32)
        mask = np.ones(b, np.float32)
        if masked:
            mask[rng.random(b) < 0.2] = 0.0
        return [torch.from_numpy(a).to(dev) for a in (x, y, mask)]

    def init(spec, c):
        return init_params(torch.Generator().manual_seed(0), dim_in, c, spec,
                           pad_input_to=F, device=dev)

    params0 = init(mspec, C)
    zeros = params0.map(torch.zeros_like)
    clone = lambda p: p.map(torch.clone)

    # the bench widths, full and ragged/masked; and one wider layer set
    # (bc=128, nl=3, C=8), whose weights do not fit in shared memory beside
    # a CTA's rows, so the kernel reads them from global memory
    cases, max_err = [], 0.0
    for name, b, masked, spec, c in (("full", B, False, mspec, C),
                                     ("ragged_masked", B - 37, True, mspec, C),
                                     ("wide_ragged_masked", 1000, True, ModelSpec(128, 3), 8)):
        x, y, mask = inputs(b, masked, c)
        p0 = init(spec, c)
        z0 = p0.map(torch.zeros_like)
        kp, km, kv = clone(p0), clone(z0), clone(z0)
        pp, pm, pv = clone(p0), clone(z0), clone(z0)
        _, _, _, kl = fs.fused_train_step(kp, km, kv, x, y, mask, 1e-3, 1, spec, c)
        _, _, _, pl = fs.fused_train_step_plain(pp, pm, pv, x, y, mask, 1e-3, 1, spec, c)
        torch.cuda.synchronize()
        err, n_ill = check_step((kp, km, kv), kl, (pp, pm, pv), pl)
        max_err = max(max_err, err)
        rows, staged = fs.cta_layout([F] + [w.shape[1] for w in p0.weights],
                                     fs._smem_optin)
        cases.append({"case": name, "B": b, "widths": [spec.base_channel, spec.num_layers, c],
                      "rows_per_cta": rows, "weights_in_smem": staged,
                      "loss": float(kl), "loss_plain": float(pl),
                      "max_abs_err_params": err, "params_with_grad_below_1e-6": n_ill})

    # 5-step chain vs the exact autograd oracle (bench.py's bounds)
    x, y, mask = inputs(B, False)
    n_steps, lr = 5, 1e-3
    kp, km, kv = clone(params0), clone(zeros), clone(zeros)
    rp, rm, rv = clone(params0), clone(zeros), clone(zeros)
    losses = []
    for t in range(1, n_steps + 1):
        _, _, _, kl = fs.fused_train_step(kp, km, kv, x, y, mask, lr, t, mspec, C)
        _, _, _, rl = fs.reference_train_step(rp, rm, rv, x, y, mask, lr, t, mspec, C)
        torch.testing.assert_close(kl, rl, rtol=1e-4, atol=1e-6)
        losses.append([float(kl), float(rl)])
    drift = max(float((a - r).abs().max()) for a, r in zip(kp.leaves(), rp.leaves()))
    assert drift < 3 * n_steps * lr, drift

    # timing at the bench shape (state keeps training; lr is irrelevant)
    tp, tm, tv = clone(params0), clone(zeros), clone(zeros)
    ms = cuda_ms(lambda: fs.fused_train_step(tp, tm, tv, x, y, mask, 1e-3, 1, mspec, C), 300)
    passes = pass_times(lambda: fs.fused_train_step(tp, tm, tv, x, y, mask, 1e-3, 1, mspec, C))
    plain_ms = cuda_ms(
        lambda: fs.fused_train_step_plain(tp, tm, tv, x, y, mask, 1e-3, 1, mspec, C), 30)
    dims = [F] + [w.shape[1] for w in params0.weights]
    P = sum(w.numel() + b.numel() for w, b in zip(params0.weights, params0.biases))
    ops, nbytes = step_cost(B, dims, P)
    kernel = kernel_entry("fused_train_step", "lbdrn_msic_tpu/ops/fused_step.py:245", card,
                          ops, nbytes, ms, plain_ms, max_err)
    emit({"phase": "kernels", "cases": cases, "chain_losses": losses,
          "chain_param_drift": drift, "ops": ops, "bytes": nbytes,
          "ms": ms, "passes": passes, "pass_2_after_pass_1_ms": ms - pass1_ms(passes),
          "design": FUSED_STEP_DESIGN, "plain_ms": plain_ms,
          "bound_ms": kernel["bound_ms"], "card": card})
    return kernel


def phase_expert_kernels(card: str):
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch.core.config import ModelSpec
    from lbdrn_msic_tpu_torch.models.siren import (
        init_params, pad_dim, stack_params, unstack_params)
    from lbdrn_msic_tpu_torch.ops import fused_step as fs

    mspec = ModelSpec()
    E, C, dim_in, B = 4, 4, 100, 8192  # the sweep's K in {3, 4, 5, 6}
    F = pad_dim(dim_in)
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    clone = lambda p: p.map(torch.clone)

    def inputs(b, densities, c):
        """(E, b) batches; one shared (b,) mask of ones (as in the sweep),
        or per-expert masks of the given densities."""
        x = np.zeros((E, b, F), np.float32)
        x[..., :dim_in] = rng.uniform(-1, 1, (E, b, dim_in))
        y = (1 / (1 + np.exp(-rng.standard_normal((E, b, c))))).astype(np.float32)
        if densities is None:
            mask = np.ones(b, np.float32)
        else:
            mask = np.stack([rng.random(b) < d for d in densities]).astype(np.float32)
        return [torch.from_numpy(a).to(dev) for a in (x, y, mask)]

    def init(spec, c):  # a different network per expert
        return stack_params([init_params(torch.Generator().manual_seed(e), dim_in, c, spec,
                                         pad_input_to=F) for e in range(E)]).to(dev)

    cases, max_err = [], 0.0
    for name, b, dens, spec, c in (
            ("full", B, None, mspec, C),
            ("ragged_per_expert_masks", B - 37, (1.0, 0.8, 0.5, 0.2), mspec, C),
            ("wide_ragged_per_expert_masks", 1000, (1.0, 0.8, 0.5, 0.0), ModelSpec(128, 3), 8)):
        x, y, mask = inputs(b, dens, c)
        p0 = init(spec, c)
        z0 = p0.map(torch.zeros_like)
        k = (clone(p0), clone(z0), clone(z0))
        p = (clone(p0), clone(z0), clone(z0))
        *_, kl = fs.fused_expert_step(*k, x, y, mask, 1e-3, 1, spec, c)
        *_, pl = fs.fused_expert_step_plain(*p, x, y, mask, 1e-3, 1, spec, c)
        torch.cuda.synchronize()
        err, n_ill = check_step(k, kl, p, pl)
        max_err = max(max_err, err)
        # expert e of K2 is K1 on expert e's slices, bit for bit
        for e in range(E):
            one = tuple(unstack_params(st, e).map(torch.clone) for st in (p0, z0, z0))
            *_, l1 = fs.fused_train_step(*one, x[e], y[e], mask[e] if mask.dim() == 2 else mask,
                                         1e-3, 1, spec, c)
            torch.cuda.synchronize()
            assert torch.equal(kl[e], l1), (name, e)
            for st2, st1 in zip(k, one):
                for a, r in zip(unstack_params(st2, e).leaves(), st1.leaves()):
                    assert torch.equal(a, r), (name, e)
        rows, staged = fs.cta_layout([F] + [w.shape[-1] for w in p0.weights], fs._smem_optin)
        cases.append({"case": name, "E": E, "B": b, "widths": [spec.base_channel,
                                                               spec.num_layers, c],
                      "mask_densities": dens, "rows_per_cta": rows, "weights_in_smem": staged,
                      "loss": kl.tolist(), "loss_plain": pl.tolist(),
                      "max_abs_err_params": err, "params_with_grad_below_1e-6": n_ill,
                      "bit_identical_to_k1_per_expert": True})

    # timing at the sweep's shape (state keeps training; lr is irrelevant)
    x, y, mask = inputs(B, None, C)
    tp = init(mspec, C)
    tm, tv = tp.map(torch.zeros_like), tp.map(torch.zeros_like)
    ms = cuda_ms(lambda: fs.fused_expert_step(tp, tm, tv, x, y, mask, 1e-3, 1, mspec, C), 300)
    passes = pass_times(lambda: fs.fused_expert_step(tp, tm, tv, x, y, mask, 1e-3, 1, mspec, C))
    plain_ms = cuda_ms(
        lambda: fs.fused_expert_step_plain(tp, tm, tv, x, y, mask, 1e-3, 1, mspec, C), 30)
    dims = [F] + [w.shape[-1] for w in tp.weights]
    P = sum(w[0].numel() + b[0].numel() for w, b in zip(tp.weights, tp.biases))
    ops, nbytes = step_cost(B, dims, P)
    kernel = kernel_entry("fused_expert_step", "lbdrn_msic_tpu/ops/fused_step.py:765", card,
                          E * ops, E * nbytes, ms, plain_ms, max_err)
    emit({"phase": "kernels_experts", "cases": cases, "E": E, "ops": E * ops,
          "bytes": E * nbytes, "ms": ms, "passes": passes,
          "pass_2_after_pass_1_ms": ms - pass1_ms(passes), "design": FUSED_STEP_DESIGN,
          "plain_ms": plain_ms, "bound_ms": kernel["bound_ms"], "card": card})
    return kernel


def phase_multi_kernels(card: str):
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch.core.config import ModelSpec
    from lbdrn_msic_tpu_torch.models.siren import (
        init_params, pad_dim, stack_params, unstack_params)
    from lbdrn_msic_tpu_torch.ops import fused_step as fs

    mspec, wide = ModelSpec(), ModelSpec(128, 3)
    C, dim_in, B = 4, 100, 8192
    F = pad_dim(dim_in)
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    clone = lambda st: tuple(p.map(torch.clone) for p in st)

    def inputs(k, E, b, masked, c):
        """k steps of (E,) b-row batches and (k, b) masks (20 % zero)."""
        lead = (k,) if E is None else (k, E)
        x = np.zeros((*lead, b, F), np.float32)
        x[..., :dim_in] = rng.uniform(-1, 1, (*lead, b, dim_in))
        y = (1 / (1 + np.exp(-rng.standard_normal((*lead, b, c))))).astype(np.float32)
        masks = np.ones((k, b), np.float32)
        if masked:
            masks[rng.random((k, b)) < 0.2] = 0.0
        return [torch.from_numpy(a).to(dev) for a in (x, y, masks)]

    def state(spec, c, E):
        """(params, m, v): one network, or E different ones stacked."""
        nets = [init_params(torch.Generator().manual_seed(e), dim_in, c, spec, pad_input_to=F)
                for e in range(E or 1)]
        p = (nets[0] if E is None else stack_params(nets)).to(dev)
        return p, p.map(torch.zeros_like), p.map(torch.zeros_like)

    def same(st_a, st_b):
        return all(torch.equal(a, b) for pa, pb in zip(st_a, st_b)
                   for a, b in zip(pa.leaves(), pb.leaves()))

    # (name, E, k, B, masked, lrs, step0, spec, C): K3 and K4 at the bench
    # widths, full; ragged/masked with a schedule and a mid-fit step0; and
    # the wide layer set, whose weights are read from global memory
    var = lambda k: [1e-3 * 0.5 ** (s % 3) for s in range(k)]
    cases, max_err = [], {"k3": 0.0, "k4": 0.0}
    for name, E, k, b, masked, lrs, step0, spec, c in (
            ("k3_full", None, 16, B, False, [1e-3] * 16, 1, mspec, C),
            ("k3_ragged_masked", None, 8, B - 37, True, var(8), 3, mspec, C),
            ("k3_wide_ragged_masked", None, 4, 1000, True, var(4), 3, wide, 8),
            ("k4_full", 4, 8, B, False, [1e-3] * 8, 1, mspec, C),
            ("k4_wide_ragged_masked", 4, 4, 1000, True, var(4), 3, wide, 8)):
        X, Y, masks = inputs(k, E, b, masked, c)
        s0 = state(spec, c, E)
        multi, single, plain, plain1 = (
            (fs.fused_multi_step, fs.fused_train_step, fs.fused_multi_step_plain,
             fs.fused_train_step_plain) if E is None else
            (fs.fused_expert_multi_step, fs.fused_expert_step, fs.fused_expert_multi_step_plain,
             fs.fused_expert_step_plain))
        kst, pst, cst = clone(s0), clone(s0), clone(s0)
        n0 = multi.launches
        *_, kl = multi(*kst, X, Y, masks, lrs, step0, spec, c)
        assert multi.launches == n0 + 1
        grid = multi.grid
        *_, pl = plain(*pst, X, Y, masks, lrs, step0, spec, c)
        # the same k steps as k chained single-step launches, each held at
        # K1's tolerances against one plain step from the same state
        cl = torch.empty_like(kl)
        err, n_ill = 0.0, 0
        for s in range(k):
            ref = clone(cst)
            *_, rl = plain1(*ref, X[s], Y[s], masks[s], lrs[s], step0 + s, spec, c)
            single(*cst, X[s], Y[s], masks[s], lrs[s], step0 + s, spec, c, loss_out=cl[s])
            torch.cuda.synchronize()
            e1, i1 = check_step(cst, cl[s], ref, rl, lr=lrs[s])
            err, n_ill = max(err, e1), max(n_ill, i1)
        key = "k3" if E is None else "k4"
        max_err[key] = max(max_err[key], err)
        assert torch.equal(kl, cl) and same(kst, cst), (name, "multi-step != chained steps")
        # the whole chunk against the plain k steps: trajectory tolerance
        # (the kernels phase's chain bounds), since an ill-conditioned
        # param's 2*lr flip feeds every later step's gradients
        torch.testing.assert_close(kl, pl, rtol=1e-4, atol=1e-6)
        drift = max(float((a - r).abs().max()) for a, r in zip(kst[0].leaves(), pst[0].leaves()))
        assert drift < 3 * k * max(lrs), (name, drift)
        if E is not None:  # expert e of K4 is K3 on expert e's slices
            for e in range(E):
                one = clone(tuple(unstack_params(p, e) for p in s0))
                *_, l3 = fs.fused_multi_step(*one, X[:, e].contiguous(), Y[:, e].contiguous(),
                                             masks, lrs, step0, spec, c)
                torch.cuda.synchronize()
                assert torch.equal(kl[:, e], l3), (name, e)
                assert same(tuple(unstack_params(p, e) for p in kst), one), (name, e)
        rows, staged = fs.cta_layout([F] + [w.shape[-1] for w in s0[0].weights], fs._smem_optin)
        cases.append({"case": name, "E": E or 1, "k": k, "B": b,
                      "widths": [spec.base_channel, spec.num_layers, c], "step0": step0,
                      "lrs": lrs, "grid_ctas": grid, "rows_per_cta": rows,
                      "weights_in_smem": staged, "losses": kl.tolist(),
                      "max_abs_err_params_per_step_vs_plain": err,
                      "params_with_grad_below_1e-6": n_ill,
                      "max_rel_err_losses_chunk_vs_plain": float(((kl - pl).abs() / pl.abs()).max()),
                      "max_abs_err_params_chunk_vs_plain": drift,
                      "bit_identical_to_chained_single_steps": True,
                      "bit_identical_to_k3_per_expert": True if E else None})

    # timing at the bench shape (state keeps training; lr is irrelevant):
    # one launch of k steps, k chained single-step launches, the plain version
    dims = [F] + [w.shape[-1] for w in state(mspec, C, None)[0].weights]
    P = sum(dims[l] * dims[l + 1] + dims[l + 1] for l in range(len(dims) - 1))
    ops, nbytes = step_cost(B, dims, P)
    kernels, timing = [], []
    for E, k, multi, single, plain, replaces in (
            (None, 16, fs.fused_multi_step, fs.fused_train_step, fs.fused_multi_step_plain,
             "lbdrn_msic_tpu/ops/fused_step.py:418"),
            (4, 8, fs.fused_expert_multi_step, fs.fused_expert_step,
             fs.fused_expert_multi_step_plain, "lbdrn_msic_tpu/ops/fused_step.py:585")):
        X, Y, masks = inputs(k, E, B, False, C)
        st = state(mspec, C, E)
        lrs = [1e-3] * k

        def chained():
            for s in range(k):
                single(*st, X[s], Y[s], masks[s], lrs[s], 1 + s, mspec, C)

        ms = cuda_ms(lambda: multi(*st, X, Y, masks, lrs, 1, mspec, C), 40, warm=3)
        chained_ms = cuda_ms(chained, 40, warm=3)
        plain_ms = cuda_ms(lambda: plain(*st, X, Y, masks, lrs, 1, mspec, C), 2, warm=1)
        n = E or 1
        entry = kernel_entry(multi.__name__, replaces, card, k * n * ops, k * n * nbytes, ms,
                             plain_ms, max_err["k3" if E is None else "k4"])
        entry["steps_per_launch"] = k
        kernels.append(entry)
        timing.append({"kernel": multi.__name__, "E": n, "k": k, "B": B, "grid_ctas": multi.grid,
                       "ms_per_launch": ms, "ms_per_step": ms / k,
                       "chained_single_step_ms": chained_ms,
                       "chained_single_step_ms_per_step": chained_ms / k,
                       "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
                       "plain_ms": plain_ms})
    emit({"phase": "kernels_multi", "cases": cases, "timing": timing, "card": card})
    return kernels


def phase_multi_k(card: str, profile: bool, k3, k4):
    """`fit` and `fit_rate_experts` at the bench shape with multi_k, the
    counterpart of scripts/profiling/multik_ab.py: interleaved runs, exact
    launch counts, every chunked fit bit-identical to its multi_k=0 fit."""
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch.codec import _prepare_tile, plan_rate_points, tile_generator
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.features.engine import lsb_scale
    from lbdrn_msic_tpu_torch.ops import fused_step as fs
    from lbdrn_msic_tpu_torch.train.loop import fit, fit_rate_experts
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene
    from lbdrn_msic_tpu_torch.utils.transfer import put_image

    H = W = 2048
    C, K = 4, 5
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=42)
    train = TrainSpec(sample_granule=8, epochs=10)
    Ks = (3, 4, 5, 6)
    cfgs = [CodecConfig(K=k, base_codec="lpc", train=train) for k in Ks]
    cfg = cfgs[Ks.index(K)]
    steps = -(-(-(-H * W // 8)) // (train.batch_size // 8))
    dev_img = put_image(img, torch.device("cuda"))
    plane, plane_scale, labels = _prepare_tile(dev_img, K, cfg.features.D)
    label_scale = float(np.float32(lsb_scale(K)))
    _, dtypes, _, _ = plan_rate_points(img, cfgs)
    kernels = (fs.fused_train_step, fs.fused_expert_step, fs.fused_multi_step,
               fs.fused_expert_multi_step)

    def fit_k(k):
        return fit(plane, plane_scale, labels, label_scale, tile_generator(train.seed, 0),
                   cfg.features, cfg.model, train, H, W, C, multi_k=k)

    def sweep_k(k):
        return fit_rate_experts(dev_img, Ks, tile_generator(train.seed, 0), cfg.features,
                                cfg.model, train, H, W, C, tap_dtypes=dtypes, multi_k=k)

    out = {}
    for what, run, ks, single, multi in (("fit", fit_k, (0, 4, 16, 64), 0, 2),
                                         ("sweep", sweep_k, (0, 8, 32), 1, 3)):
        rows = {k: {"multi_k": k, "seconds": [], "launches": []} for k in ks}
        ref = None
        for rnd in range(3):  # one warm round, two timed, interleaved
            for k in ks:
                for kern in kernels:
                    kern.launches = 0
                torch.cuda.synchronize()
                t0 = time.time()
                res = run(k)
                torch.cuda.synchronize()
                secs = time.time() - t0
                counts = [kern.launches for kern in kernels]
                want = [0, 0, 0, 0]
                if k:
                    want[multi] = train.epochs * -(-steps // k)
                else:
                    want[single] = train.epochs * steps
                assert counts == want, (what, k, counts, want)
                ref = ref or res
                assert same_fit(res, ref), (what, k, "chunked fit differs from multi_k=0")
                if rnd:
                    rows[k]["seconds"].append(secs)
                rows[k]["launches"] = counts[multi] if k else counts[single]
        base = float(np.median(rows[0]["seconds"]))
        for k in ks:
            r = rows[k]
            r["kernel"] = kernels[multi if k else single].__name__
            r["identical_to_multi_k_0"] = True
            r["median_s_vs_multi_k_0"] = float(np.median(r["seconds"])) / base
        out[what] = [rows[k] for k in ks]
    k3["launches"] = out["fit"][2]["launches"]  # at k = 16, as timed in kernels_multi
    k4["launches"] = out["sweep"][1]["launches"]  # at k = 8
    emit({"phase": "multi_k", "shape": [C, H, W], "steps_per_epoch": steps,
          "epochs": train.epochs, "fit_K": K, "sweep_Ks": list(Ks), **out, "card": card})

    if profile:
        for row in out["fit"][:3:2]:  # multi_k 0 and 16
            phase_profile(f"fit multi_k={row['multi_k']}", lambda: fit_k(row["multi_k"]),
                          row["seconds"])


def mv_dist(st_a, st_b) -> float:
    """The largest |m_a - m_b| or |v_a - v_b| over the largest |m_b| or
    |v_b| (each of m and v against its own largest)."""
    out = 0.0
    for ka, kb in ((st_a[1], st_b[1]), (st_a[2], st_b[2])):
        scale = max(float(t.abs().max()) for t in kb.leaves()) or 1.0
        for a, r in zip(ka.leaves(), kb.leaves()):
            out = max(out, float((a - r).abs().max()) / scale)
    return out


def check_bf16(what: str, k_state, k_loss, p_state, p_loss, f_state=None, n_steps: int = 1,
               lr: float = 1e-3):
    """Steps at mm_dtype "bfloat16" against the plain version's from the
    same state: the same rounded operands, but a last-bit f32 difference
    upstream (summation order) can flip an operand's bf16 rounding (2^-8
    relative).  Losses at rtol 1e-4, params within 2*lr a step.  One step
    (n_steps = 1): m and v within 1e-5 of the largest (measured <= 7e-7 on
    an H100), and, against `f_state`, the f32 plain step from the same
    state, at least 10x farther (the bf16 gradient is ~3e-3 of the largest
    from the f32 one), so that a kernel which skips the bf16 rounding
    fails; params held tightly where |g| is above the noise (the update is
    ~lr * sign(g)).  k chained steps: m and v within 2e-2 (the JAX bf16
    tier, tests/test_fused_step.py:166), since past step 1 the update
    follows the gradients' ratios and so their bf16 noise.  Returns (max
    abs param difference, m/v distance to the bf16 plain step, to the f32
    one or None)."""
    import torch

    msg = lambda m: f"{what}: {m}"
    torch.testing.assert_close(k_loss, p_loss, rtol=1e-4, atol=0, msg=msg)
    mv = mv_dist(k_state, p_state)
    mv_f32 = None
    if n_steps == 1:
        assert f_state is not None
        mv_f32 = mv_dist(k_state, f_state)
        assert mv <= 1e-5 and mv_f32 >= 10 * mv, (what, "bf16 vs plain", mv, "vs f32", mv_f32)
    else:
        assert mv <= 2e-2, (what, mv)
    (kp, _, _), (pp, pm, _) = k_state, p_state
    gscale = max(float(t.abs().max()) for t in pm.leaves())
    err = 0.0
    for a, r, m in zip(kp.leaves(), pp.leaves(), pm.leaves()):
        if n_steps == 1:
            well = m.abs() >= 2e-2 * gscale
            torch.testing.assert_close(a[well], r[well], rtol=2e-4, atol=1e-6, msg=msg)
        err = max(err, float((a - r).abs().max()))
    assert err <= 2 * lr * n_steps, (what, err)
    return err, mv, mv_f32


def phase_mm_dtype(card: str, fits: bool):
    """K1-K4 at mm_dtype "bfloat16" against their plain versions, and (with
    `fits`) the counterpart of scripts/profiling/mm_ab.py."""
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch.core.config import ModelSpec
    from lbdrn_msic_tpu_torch.models.siren import init_params, pad_dim, stack_params
    from lbdrn_msic_tpu_torch.ops import fused_step as fs

    bf = "bfloat16"
    mspec, wide = ModelSpec(), ModelSpec(128, 3)
    C, dim_in, B = 4, 100, 8192
    F = pad_dim(dim_in)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    clone = lambda st: tuple(p.map(torch.clone) for p in st)

    def state(spec, c, E):
        nets = [init_params(torch.Generator().manual_seed(e), dim_in, c, spec, pad_input_to=F)
                for e in range(E or 1)]
        p = (nets[0] if E is None else stack_params(nets)).to(dev)
        return p, p.map(torch.zeros_like), p.map(torch.zeros_like)

    def same(st_a, st_b):
        return all(torch.equal(a, b) for pa, pb in zip(st_a, st_b)
                   for a, b in zip(pa.leaves(), pb.leaves()))

    cases = []
    for name, E, k, b, masked, spec, c in (
            ("k1_full", None, 0, B, False, mspec, C),
            ("k1_wide_ragged_masked", None, 0, 1000, True, wide, 8),
            ("k2_full", 4, 0, B, False, mspec, C),
            ("k3_full", None, 8, B, False, mspec, C),
            ("k4_full", 4, 4, B, False, mspec, C)):
        lead = ((k,) if k else ()) + ((E,) if E else ())
        x = np.zeros((*lead, b, F), np.float32)
        x[..., :dim_in] = rng.uniform(-1, 1, (*lead, b, dim_in))
        y = (1 / (1 + np.exp(-rng.standard_normal((*lead, b, c))))).astype(np.float32)
        mask = np.ones((k, b) if k else (b,), np.float32)
        if masked:
            mask[rng.random(mask.shape) < 0.2] = 0.0
        x, y, mask = (torch.from_numpy(a).to(dev) for a in (x, y, mask))
        kern, plain, single, single_plain = {
            (False, False): (fs.fused_train_step, fs.fused_train_step_plain, None, None),
            (True, False): (fs.fused_expert_step, fs.fused_expert_step_plain, None, None),
            (False, True): (fs.fused_multi_step, fs.fused_multi_step_plain, fs.fused_train_step,
                            fs.fused_train_step_plain),
            (True, True): (fs.fused_expert_multi_step, fs.fused_expert_multi_step_plain,
                           fs.fused_expert_step, fs.fused_expert_step_plain)}[E is not None, k > 0]
        sched = ([1e-3] * k, 1) if k else (1e-3, 1)
        s0 = state(spec, c, E)
        kst, pst = clone(s0), clone(s0)
        n0 = kern.launches
        *_, kl = kern(*kst, x, y, mask, *sched, spec, c, mm_dtype=bf)
        assert kern.launches == n0 + 1
        *_, pl = plain(*pst, x, y, mask, *sched, spec, c, mm_dtype=bf)
        torch.cuda.synchronize()
        row = {"case": name, "E": E or 1, "k": k or 1, "B": b,
               "widths": [spec.base_channel, spec.num_layers, c], "loss": kl.tolist(),
               "loss_plain": pl.tolist()}
        if k:
            # one bf16 launch is k chained bf16 single-step launches, bit for
            # bit, and the first of those is held as a single step is below
            err, mv, _ = check_bf16(name, kst, kl, pst, pl, n_steps=k)
            cst = clone(s0)
            cl = torch.empty_like(kl)
            for st in range(k):
                single(*cst, x[st], y[st], mask[st], 1e-3, 1 + st, spec, c, loss_out=cl[st],
                       mm_dtype=bf)
                if st == 0:
                    first = clone(cst), cl[0].clone()
            torch.cuda.synchronize()
            assert torch.equal(kl, cl) and same(kst, cst), (name, "bf16 multi-step != chained")
            row["bit_identical_to_chained_single_steps"] = True
            kst, kl, s_args = first[0], first[1], (x[0], y[0], mask[0], 1e-3, 1)
            pst, fst = clone(s0), clone(s0)
            pl = single_plain(*pst, *s_args, spec, c, mm_dtype=bf)[-1]
            single_plain(*fst, *s_args, spec, c)
            row["chain_max_abs_err_params"], row["chain_max_mv_err_over_largest"] = err, mv
            name += ": first chained step"
        else:
            fst = clone(s0)
            plain(*fst, x, y, mask, *sched, spec, c)
        torch.cuda.synchronize()
        err, mv, mv_f32 = check_bf16(name, kst, kl, pst, pl, fst)
        row.update({"max_abs_err_params": err, "max_mv_err_over_largest": mv,
                    "mv_err_vs_f32_plain_over_largest": mv_f32})
        cases.append(row)

    out = {"phase": "mm_dtype", "cases": cases}
    if fits:
        from lbdrn_msic_tpu_torch.profiling import mm_ab

        fs.fused_train_step.launches = 0
        rows = mm_ab.ab(rounds=2)
        n_fits = 3 * len(mm_ab.MM_DTYPES)
        assert fs.fused_train_step.launches == n_fits * 5120, fs.fused_train_step.launches
        out["mm_ab"] = {str(k): v for k, v in rows.items()}
        out["mm_ab_k1_launches_per_fit"] = fs.fused_train_step.launches // n_fits
    emit({**out, "card": card})


def adam_bound(t: int) -> float:
    """The largest |m| / sqrt(v) of Adam at step t from zero state without
    bias correction (c1 = c2 = 1, as K5 runs): Cauchy-Schwarz over the
    gradients' weights in m and v."""
    return sum((0.1 * 0.9 ** (t - i)) ** 2 / (0.001 * 0.999 ** (t - i))
               for i in range(1, t + 1)) ** 0.5


def phase_kernel_prof(card: str):
    """K5: every variant's kernel against its plain version, then the
    profiling path variant by variant, counts zeroed before each."""
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch.models.siren import SirenParams
    from lbdrn_msic_tpu_torch.ops import fused_step as fs
    from lbdrn_msic_tpu_torch.profiling import kernel_prof as kp

    inputs = kp.make_inputs(seed=0)
    ws, bs, x, y, mask = inputs
    lr = kp.LR

    def state():
        p = SirenParams([w.clone() for w in ws], [b.clone() for b in bs])
        return p, p.map(torch.zeros_like), p.map(torch.zeros_like)

    # kernel against plain from the same state, per product: (loss rtol, m/v
    # within this fraction of the largest; params tight where |g| is above
    # it and above 1e-4 of the largest); the 5-step chain's losses at the
    # third rtol (c1 = c2 = 1 makes every update ~3 lr * sign(m), so the
    # chain amplifies step 1's differences).  The tensor cores' f32
    # accumulation is not IEEE round-to-nearest: 3xTF32's step-1 m, v differ
    # from its plain emulation ~100x more than FFMA's do, hence its chain
    # tier is TF32's.  bf16 (K1's rounded operands, FFMA products) holds m, v
    # within 1e-5 (measured 6e-7 on an H100), and they must lie at least 10x
    # farther from the f32 plain step (prod_f32's) than from its own, so that
    # a kernel which skips the bf16 rounding fails.  Every check is measured
    # and recorded first; the phase fails after its line.
    tiers = {"f32": (1e-5, 1e-4, 1e-3), "3xtf32": (1e-5, 1e-3, 1e-2),
             "tf32": (1e-4, 1e-2, 1e-2), "bf16": (1e-4, 1e-5, 1e-2)}
    checks, failed, kernel_states = [], [], {}
    chain_bound = 2 * lr * sum(adam_bound(t) for t in range(1, 6))
    for name, (mode, _, _) in kp.VARIANTS.items():
        product = kp.PRODUCT.get(mode, "f32")
        loss_rtol, mv_frac, chain_rtol = tiers[product]
        kst, pst = state(), state()
        kl = float(kp.variant_step(*kst, x, y, mask, name))
        pl = float(kp.variant_step_plain(*pst, x, y, mask, name))
        kernel_states[name] = (tuple(p.map(torch.clone) for p in kst), kl)
        mv = mv_dist(kst, pst)
        gscale = max(float(t.abs().max()) for t in pst[1].leaves())
        err, tight = 0.0, -1.0
        for a, r, m in zip(kst[0].leaves(), pst[0].leaves(), pst[1].leaves()):
            well = m.abs() >= max(mv_frac, 1e-4) * gscale  # |g| well above the noise
            if bool(well.any()):  # > 0 where |a - r| exceeds rtol 2e-4, atol 1e-6
                tight = max(tight, float(((a - r).abs() - 2e-4 * r.abs() - 1e-6)[well].max()))
            err = max(err, float((a - r).abs().max()))
        ok = {"loss": abs(kl - pl) <= loss_rtol * abs(pl), "m_v": mv <= mv_frac,
              "params_tight_where_well_conditioned": tight <= 0,
              "params_within_adam_bound": err <= 2 * adam_bound(1) * lr}
        mv_f32 = None
        if product == "bf16":
            fst = state()
            kp.variant_step_plain(*fst, x, y, mask, "prod_f32")
            mv_f32 = mv_dist(kst, fst)
            ok["m_v_farther_from_f32"] = mv_f32 >= 10 * mv
        if mode == "fwd_notrans":  # forward only: the state is untouched
            ok["state_unchanged"] = (
                all(torch.equal(a, b) for a, b in zip(kst[0].leaves(), ws + bs))
                and all(float(t.abs().max()) == 0 for t in kst[1].leaves() + kst[2].leaves()))
        # a 5-step chain, kernel against plain, each from its own last state
        chain = [[kl, pl]]
        for _ in range(4):
            chain.append([float(kp.variant_step(*kst, x, y, mask, name)),
                          float(kp.variant_step_plain(*pst, x, y, mask, name))])
        chain_err = max(abs(kc - pc) / abs(pc) for kc, pc in chain)
        drift = max(float((a - r).abs().max()) for a, r in zip(kst[0].leaves(), pst[0].leaves()))
        ok["chain_losses"] = chain_err <= chain_rtol
        ok["chain_params_within_adam_bound"] = drift <= chain_bound
        if mode == "fwd_notrans":
            ok["chain_losses_unchanged"] = all(kc == kl for kc, _ in chain)
        failed += [f"{name}: {what}" for what, good in ok.items() if not good]
        checks.append({"variant": name, "product": product, "loss": kl, "loss_plain": pl,
                       "tiers": {"loss_rtol": loss_rtol, "m_v": mv_frac, "chain_rtol": chain_rtol},
                       "max_mv_err_over_largest": mv, "mv_err_vs_f32_plain_over_largest": mv_f32,
                       "max_abs_err_params": err,
                       "chain_losses": chain, "chain_max_rel_err": chain_err,
                       "chain_param_drift": drift, "chain_param_bound": chain_bound, "ok": ok})
    # same function, other layout or rows: full_t is full_dg bit for bit (the
    # same sums over the same values); tile2048 is full_dg to summation order
    (ta, la), (da, ld), (ga, lg) = (kernel_states[n] for n in ("full_t", "full_dg", "tile2048"))
    if not (la == ld and all(torch.equal(a, b) for sa, sb in zip(ta, da)
                             for a, b in zip(sa.leaves(), sb.leaves()))):
        failed.append("full_t != full_dg bit for bit")
    tile_mv = max(float((a - b).abs().max()) / float(b.abs().max())
                  for sa, sb in zip(ga[1:], da[1:]) for a, b in zip(sa.leaves(), sb.leaves())
                  if float(b.abs().max()))
    if abs(lg - ld) > 1e-5 * abs(ld) or tile_mv > 1e-4:
        failed.append(f"tile2048 vs full_dg: loss {lg} vs {ld}, m/v {tile_mv}")

    # the profiling path, variant by variant: counts zeroed, three 512-step
    # runs, counts read
    counted = (fs.fused_train_step, fs.fused_expert_step, fs.fused_multi_step,
               fs.fused_expert_multi_step)
    dims = [kp.F, kp.BC, kp.BC, kp.C]
    P = sum(dims[l] * dims[l + 1] + dims[l + 1] for l in range(3))
    ops, nbytes = step_cost(kp.B, dims, P)
    mm_ops = 2 * kp.B * (2 * sum(dims[l] * dims[l + 1] for l in range(3))
                         + sum(dims[l] * dims[l + 1] for l in range(1, 3)))
    rounds, kernels, timing = 3, [], []
    for name, (mode, _, _) in kp.VARIANTS.items():
        product = kp.PRODUCT.get(mode, "f32")
        kp.variant_step.launches = dict.fromkeys(kp.KERNEL_VARIANTS, 0)
        for kern in counted:
            kern.launches = 0
        runs = kp.profile([name], rounds, inputs)[name]
        ms_run = float(np.median(runs))  # as K1-K4's (the printed line is the best)
        k5 = dict(kp.variant_step.launches)
        k1 = fs.fused_train_step.launches
        assert all(kern.launches == 0 for kern in counted[1:])
        if mode.startswith("prod"):  # K1 itself
            launches = k1
            assert sum(k5.values()) == 0, k5
        else:
            launches = k5[name]
            assert k1 == 0 and sum(k5.values()) == launches, (k1, k5)
        assert launches == rounds * kp.STEPS, (name, launches)
        st = state()
        plain_ms = cuda_ms(lambda: kp.variant_step_plain(*st, x, y, mask, name), 10, warm=2)
        if mode == "fwd_notrans":
            v_ops = {"f32": 2 * kp.B * sum(dims[l] * dims[l + 1] for l in range(3))}
            v_bytes = 4 * (kp.B * (kp.F + kp.C + 1) + P + 1)
        elif product == "f32":
            v_ops, v_bytes = ops, nbytes
        else:  # the products at their type's tensor-core peak (three for 3xTF32)
            unit = "bf16" if product == "bf16" else "tf32"
            v_ops = {unit: mm_ops * (3 if product == "3xtf32" else 1), "f32": ops - mm_ops}
            v_bytes = nbytes
        err = next(c["max_abs_err_params"] for c in checks if c["variant"] == name)
        source = ("lbdrn_msic_tpu_torch/csrc/fused_step.cu" if mode.startswith("prod")
                  else "lbdrn_msic_tpu_torch/csrc/kernel_prof.cu")
        entry = kernel_entry(f"kernel_prof:{name}", "scripts/profiling/kernel_prof.py:218", card,
                             v_ops, v_bytes, ms_run / kp.STEPS, plain_ms, err, source)
        entry["launches"] = launches
        entry["steps_per_run"] = kp.STEPS
        kernels.append(entry)
        timing.append({"variant": name, "product": product, "rows_per_cta": kp.cta_rows(name),
                       "ms_512_steps": ms_run, "ms_512_steps_runs": runs,
                       "ms_per_step": ms_run / kp.STEPS,
                       "bound_ms_per_step": entry["bound_ms"], "bound_by": entry["bound_by"],
                       "plain_ms_per_step": plain_ms, "launches": launches,
                       "kernel": "K1" if mode.startswith("prod") else "K5"})
    emit({"phase": "kernel_prof", "B": kp.B, "widths": dims, "checks": checks,
          "full_t_bit_identical_to_full_dg": "full_t != full_dg bit for bit" not in failed,
          "tile2048_vs_full_dg_max_mv_err_over_largest": tile_mv, "timing": timing,
          "failed": failed, "card": card})
    assert not failed, failed
    return kernels


def busy_seconds(prof) -> float:
    """Seconds in which the device ran at least one kernel, copy or set: the
    union of the device events' intervals (a sum would count twice the
    time in which a programmatic dependent launch overlaps its primary)."""
    import torch

    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def phase_profile(what: str, run, secs):
    """One more run of `run` under torch.profiler: device time by kernel
    name and the device's busy share of the run's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies, sets): the host-side
        # aten:: entries carry the same device time again
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = busy_seconds(prof)
    step_us = sum(r[0] for r in rows if any(k in r[1] for k in FUSED_STEP_KERNELS))
    emit({"phase": "profile", "of": what, "wall_s_profiled": wall,
          "wall_s_unprofiled": min(secs), "device_busy_s": busy,
          "device_kernel_time_sum_s": sum(r[0] for r in rows) / 1e6,
          "fused_step_kernels_device_s": step_us / 1e6,
          "other_device_s": (sum(r[0] for r in rows) - step_us) / 1e6,
          "device_busy_share": busy / wall,
          "top": [{"kernel": k[:80], "device_ms": us / 1e3, "calls": n}
                  for us, k, n in rows[:12]]})


def phase_codec(profile: bool, kernel):
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch.codec import decode_stream, encode_image
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.eval.metrics import psnr
    from lbdrn_msic_tpu_torch.ops.fused_step import fused_expert_step, fused_train_step
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene

    H = W = 2048
    mpx = H * W / 1e6
    img = synth_scene(H, W, channels=4, effective_bits=12, seed=42)
    cfg = CodecConfig(K=5, base_codec="lpc", train=TrainSpec(sample_granule=8, epochs=10))
    n_steps = cfg.train.epochs * -(-(-(-H * W // 8)) // (cfg.train.batch_size // 8))

    t0 = time.time()
    warm_stream, _ = encode_image(img, cfg)
    warm_s = time.time() - t0
    streams, secs, launches = [], [], []
    for _ in range(3):
        fused_train_step.launches = fused_expert_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        stream, stats = encode_image(img, cfg)
        secs.append(time.time() - t0)
        launches.append(fused_train_step.launches)
        assert fused_expert_step.launches == 0, fused_expert_step.launches
        streams.append(stream)
    assert launches == [n_steps] * 3, (launches, n_steps)
    kernel["launches"] = launches[0]
    kernel["launches_by_path"] = {"encode": launches[0]}
    emit({"phase": "encode", "shape": [4, H, W], "warm_s": warm_s, "seconds": secs,
          "mpx_s": [mpx / s for s in secs], "phases": stats.phases,
          "bpsp": stats.bpsp, "best_epoch": stats.tiles[0].best_epoch,
          "best_mse": stats.tiles[0].best_mse, "launches": launches,
          "expected_launches": n_steps, "sha256": hashlib.sha256(streams[0]).hexdigest()})

    if profile:
        phase_profile("encode", lambda: encode_image(img, cfg), secs)

    assert all(s == warm_stream for s in streams), "same seed gave different streams"
    emit({"phase": "determinism", "encodes": 1 + len(streams), "identical": True,
          "bytes": len(warm_stream)})

    dsecs = []
    for _ in range(3):
        t0 = time.time()
        rec, dstats = decode_stream(streams[0])
        dsecs.append(time.time() - t0)
    assert rec.shape == img.shape and rec.dtype == np.uint16
    assert np.array_equal(rec >> cfg.K, img >> cfg.K), "MSB path corrupted"
    p = psnr(img, rec)
    emit({"phase": "decode", "seconds": dsecs, "mpx_s": [mpx / s for s in dsecs],
          "phases": dstats.phases, "psnr_db": p, "bpsp": stats.bpsp,
          "jax_package_rd_point": {"psnr_db": 61.79, "bpsp": 1.958,
                                   "source": "BENCH_r05.json"}})

    t0 = time.time()
    s_x, st_x = encode_image(img, cfg, use_fused=False)
    exact_s = time.time() - t0
    p_x = psnr(img, decode_stream(s_x)[0])
    assert abs(p - p_x) < 0.1, (p, p_x)
    emit({"phase": "rd", "shape": [4, H, W], "psnr_fused_db": p,
          "psnr_exact_step_db": p_x, "bpsp_fused": stats.bpsp, "bpsp_exact_step": st_x.bpsp,
          "exact_step_encode_s": exact_s})


def phase_sweep(profile: bool, kernel):
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch.codec import (
        decode_stream, encode_image, encode_rate_points, plan_rate_points)
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.eval.metrics import psnr
    from lbdrn_msic_tpu_torch.ops.fused_step import fused_expert_step, fused_train_step
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene

    H = W = 2048
    mpx = H * W / 1e6
    img = synth_scene(H, W, channels=4, effective_bits=12, seed=42)
    Ks = (3, 4, 5, 6)
    train = TrainSpec(sample_granule=8, epochs=10)
    cfgs = [CodecConfig(K=K, base_codec="lpc", train=train) for K in Ks]
    n_steps = train.epochs * -(-(-(-H * W // 8)) // (train.batch_size // 8))
    staging, dtypes, groups, staged = plan_rate_points(img, cfgs)
    assert staging == "full" and groups == [list(range(len(Ks)))], (staging, groups)

    t0 = time.time()
    warm = [s for s, _ in encode_rate_points(img, cfgs)]
    warm_s = time.time() - t0
    secs, launches = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        fused_train_step.launches = fused_expert_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        res = encode_rate_points(img, cfgs)
        secs.append(time.time() - t0)
        launches.append(fused_expert_step.launches)
        assert fused_train_step.launches == 0, fused_train_step.launches
        assert [s for s, _ in res] == warm, "same seed gave different sweep streams"
    assert launches == [n_steps] * 3, (launches, n_steps)
    kernel["launches"] = launches[0]
    kernel["launches_by_path"] = {"sweep": launches[0]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    points = []
    for cfg, (stream, stats) in zip(cfgs, res):
        rec, _ = decode_stream(stream)
        assert rec.shape == img.shape and np.array_equal(rec >> cfg.K, img >> cfg.K), cfg.K
        solo, solo_stats = encode_image(img, cfg)
        p, p_solo = psnr(img, rec), psnr(img, decode_stream(solo)[0])
        assert abs(p - p_solo) < 0.1, (cfg.K, p, p_solo)
        points.append({"K": cfg.K, "psnr_db": p, "bpsp": stats.bpsp,
                       "best_epoch": stats.tiles[0].best_epoch,
                       "best_mse": stats.tiles[0].best_mse,
                       "identical_to_encode_image": solo == stream,
                       "sha256": hashlib.sha256(stream).hexdigest(),
                       "psnr_encode_image_db": p_solo, "bpsp_encode_image": solo_stats.bpsp})
    emit({"phase": "sweep", "shape": [4, H, W], "Ks": list(Ks), "staging": staging,
          "tap_dtypes": [str(d).replace("torch.", "") for d in dtypes],
          "staged_tap_bytes": sum(staged), "warm_s": warm_s, "seconds": secs,
          "mpx_s_per_point": [mpx * len(Ks) / s for s in secs],
          "phases": res[0][1].phases, "launches": launches, "expected_launches": n_steps,
          "deterministic": True, "peak_device_gb": peak_gb, "points": points})

    if profile:
        phase_profile("sweep", lambda: encode_rate_points(img, cfgs), secs)


def same_fit(a, b) -> bool:
    """Two fits bit for bit: step losses, best MSE and epoch, best params."""
    import torch

    return (torch.equal(a.step_losses, b.step_losses) and a.best_epoch == b.best_epoch
            and a.best_mse == b.best_mse
            and all(torch.equal(x, y) for x, y in zip(a.params.leaves(), b.params.leaves())))


def counted_run(fn):
    """fn() with the K1 / K2 launch counts zeroed just before it and read
    just after, and the device's peak memory over it: (result, seconds,
    [K1, K2] launches, peak GB)."""
    import torch

    from lbdrn_msic_tpu_torch.ops.fused_step import fused_expert_step, fused_train_step

    fused_train_step.launches = fused_expert_step.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.time() - t0, [fused_train_step.launches, fused_expert_step.launches],
            torch.cuda.max_memory_allocated() / 1e9)


def phase_staging(profile: bool, k1, k2):
    """Training above the feature-cache budget: (a) `fit` in each forced
    mode at the bench scene against "cached"; (b) GF-2-sized encodes that
    `pick_staging` routes to "full" (K=5) and "banded" (K=3), decoded; (c)
    the GF-2 rate sweep, banded.  One run each."""
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch.codec import (
        _prepare_tile, _staging_bytes, _tap_itemsize, decode_stream, encode_image,
        encode_rate_points, plan_rate_points, tile_generator)
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.eval.metrics import psnr
    from lbdrn_msic_tpu_torch.features.engine import lsb_scale
    from lbdrn_msic_tpu_torch.train.loop import _batch_geometry, fit
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene
    from lbdrn_msic_tpu_torch.utils.transfer import put_image

    t_phase = time.time()
    # (a) the bench scene, e=2, each forced mode against "cached" at its
    # granule: W % 8 == 0, so "full" and "banded" see "cached"'s granules
    H = W = 2048
    C, K = 4, 5
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=42)
    plane, scale, labels = _prepare_tile(put_image(img, torch.device("cuda")), K, 2)
    ls = float(np.float32(lsb_scale(K)))
    forced = []
    for g, modes in ((8, ("cached", "full", "banded")), (1, ("cached", "gather"))):
        train = TrainSpec(sample_granule=g, epochs=2)
        cfg = CodecConfig(K=K, base_codec="lpc", train=train)
        fits = {}
        for st in modes:
            res, secs, launches, peak = counted_run(
                lambda: fit(plane, scale, labels, ls, tile_generator(train.seed, 0), cfg.features,
                            cfg.model, train, H, W, C, staging=st))
            want = train.epochs * _batch_geometry(train, H, W, st).steps
            assert launches == [want, 0], (st, g, launches, want)
            fits[st] = res
            if st != "cached":
                assert same_fit(res, fits["cached"]), (st, g, "differs from cached")
            forced.append({"staging": st, "sample_granule": g, "seconds": secs,
                           "launches_k1": launches[0], "staged_bytes": res.staged_bytes,
                           "peak_device_gb": peak, "best_mse": res.best_mse,
                           "best_epoch": res.best_epoch,
                           "bit_identical_to_cached": st != "cached" or None})
    del plane, scale, labels, fits
    a_s = time.time() - t_phase

    # (b) a GF-2-sized scene (reference DLPR_nll_results.py:89-103:
    # 7605x7815x4, 12-bit) at the bench config, e=10: above the cache budget
    t0 = time.time()
    H, W = 7605, 7815
    big = synth_scene(H, W, channels=C, effective_bits=12, seed=42, fast=True)
    synth_s = time.time() - t0
    train = TrainSpec(sample_granule=8, epochs=10)
    mx = int(big.max())

    def decoded(stream, K_):
        (rec, _), secs, launches, peak = counted_run(lambda: decode_stream(stream))
        assert rec.shape == big.shape and np.array_equal(rec >> K_, big >> K_), K_
        assert launches == [0, 0]
        return {"psnr_db": psnr(big, rec), "decode_s": secs, "decode_peak_device_gb": peak}

    def estimate(cfg, staging):
        full, banded = _staging_bytes(H, W, C, cfg.features, 8,
                                      _tap_itemsize(mx >> cfg.K, cfg.features.relative),
                                      _tap_itemsize(mx >> cfg.K, False))
        return full if staging == "full" else banded

    encodes, streams = [], {}
    for K_, want in ((5, "full"), (3, "banded")):
        cfg = CodecConfig(K=K_, base_codec="lpc", train=train)
        (stream, stats), secs, launches, peak = counted_run(lambda: encode_image(big, cfg))
        tile = stats.tiles[0]
        steps = _batch_geometry(train, H, W, want).steps
        assert tile.staging == want and steps == 7256, (K_, tile.staging, steps)
        assert launches == [train.epochs * steps, 0], (K_, launches)
        streams[K_] = stream
        row = {"K": K_, "staging": tile.staging, "seconds": secs, "phases": stats.phases,
               "launches_k1": launches[0], "launches_k2": launches[1],
               "staged_bytes": tile.staged_bytes, "staged_bytes_estimate": estimate(cfg, want),
               "peak_device_gb": peak, "best_epoch": tile.best_epoch,
               "best_mse": tile.best_mse, "bpsp": stats.bpsp,
               "sha256": hashlib.sha256(stream).hexdigest()}
        row.update(decoded(stream, K_))
        encodes.append(row)
        k1["launches_by_path"][f"gf2_encode_{want}"] = launches[0]
    b_s = time.time() - t0

    # (c) the GF-2 rate sweep: every expert's banded row taps in one group
    t0 = time.time()
    Ks = (3, 4, 5, 6)
    cfgs = [CodecConfig(K=k, base_codec="lpc", train=train) for k in Ks]
    staging, dtypes, groups, per_expert = plan_rate_points(big, cfgs)
    assert staging == "banded" and groups == [[0, 1, 2, 3]], (staging, groups)
    res, secs, launches, peak = counted_run(lambda: encode_rate_points(big, cfgs))
    assert launches == [0, train.epochs * 7256], launches
    k2["launches_by_path"]["gf2_sweep_banded"] = launches[1]
    points = []
    for cfg, (stream, stats) in zip(cfgs, res):
        assert stats.tiles[0].staging == "banded"
        pt = {"K": cfg.K, "bpsp": stats.bpsp, "best_epoch": stats.tiles[0].best_epoch,
              "best_mse": stats.tiles[0].best_mse, "sha256": hashlib.sha256(stream).hexdigest()}
        pt.update(decoded(stream, cfg.K))
        points.append(pt)
    by_k = {p["K"]: p for p in points}
    enc = {r["K"]: r for r in encodes}
    # K=3: both banded, so the same network and bytes; K=5: "full" and
    # "banded" draw different granule grids (W % 8 != 0), so RD only
    assert res[Ks.index(3)][0] == streams[3], "sweep K=3 differs from the banded encode"
    assert abs(by_k[5]["psnr_db"] - enc[5]["psnr_db"]) < 0.1, (by_k[5], enc[5])
    sweep = {"Ks": list(Ks), "staging": staging,
             "raw_dtypes": [str(d).replace("torch.", "") for d in dtypes],
             "seconds": secs, "phases": res[0][1].phases, "launches_k1": launches[0],
             "launches_k2": launches[1], "staged_bytes": res[0][1].tiles[0].staged_bytes,
             "staged_bytes_estimate": sum(per_expert), "peak_device_gb": peak,
             "k3_identical_to_banded_encode": True,
             "k5_psnr_vs_full_encode_db": by_k[5]["psnr_db"] - enc[5]["psnr_db"],
             "points": points}
    c_s = time.time() - t0
    emit({"phase": "staging", "bench_forced_modes": forced,
          "gf2": {"shape": [C, H, W], "synth": "synth_scene(fast=True), seed 42",
                  "synth_s": synth_s, "epochs": train.epochs, "steps_per_epoch": 7256,
                  "encodes": encodes, "sweep": sweep},
          "phase_seconds": {"a_forced_modes": a_s, "b_gf2_encodes": b_s, "c_gf2_sweep": c_s,
                            "total": time.time() - t_phase}})

    if profile:  # one epoch of the GF-2 fit in each mode: staging, batch assembly, K1
        for K_, want in ((5, "full"), (3, "banded")):
            cfg = CodecConfig(K=K_, base_codec="lpc", train=TrainSpec(sample_granule=8, epochs=1))
            secs = counted_run(lambda: encode_image(big, cfg))[1]
            phase_profile(f"gf2 encode e=1 {want}", lambda: encode_image(big, cfg), [secs])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels",), default=None)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one encode, one sweep, two fits and two GF-2 epochs "
                         "with torch.profiler")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    from lbdrn_msic_tpu_torch.codecs import _native
    from lbdrn_msic_tpu_torch.ops import _build

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    def timed(fn):
        t0 = time.time()
        fn()
        return time.time() - t0

    def native():
        assert _native.load() is not None, f"native codec library did not load: {_native.load_error}"

    # nvcc (one per kernel source) and g++ (the host codecs) side by side
    sources = ("fused_step", "kernel_prof")
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as pool:
        k_futs = {src: pool.submit(timed, lambda s=src: _build.load(s)) for src in sources}
        n_fut = pool.submit(timed, native)
        k_s = {src: f.result() for src, f in k_futs.items()}
        n_s = n_fut.result()
    emit({"phase": "build", "kernel_s": k_s, "native_s": n_s,
          "ptxas": {src: [ln for ln in _build.build_log.get(src, {}).get("ptxas", "").splitlines()
                          if any(w in ln for w in ("entry function", "registers", "spill"))]
                    for src in sources}})

    k1 = phase_kernels(card)
    k2 = phase_expert_kernels(card)
    k3, k4 = phase_multi_kernels(card)
    phase_mm_dtype(card, fits=args.only != "kernels")
    k5 = phase_kernel_prof(card)
    if args.only != "kernels":
        phase_codec(args.profile, k1)
        phase_sweep(args.profile, k2)
        phase_multi_k(card, args.profile, k3, k4)
        phase_staging(args.profile, k1, k2)
    emit({"kernels": [k1, k2, k3, k4, *k5]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
