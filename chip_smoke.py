"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py              # every phase (needs one CUDA card)
    python3 chip_smoke.py --only kernels
    python3 chip_smoke.py --profile    # adds a torch.profiler encode breakdown

Phases, one JSON line each (every phase asserts; nothing is caught):
  env      card name and power limit, TF32 switched off
  build    nvcc build of csrc/fused_step.cu and g++ build of the host codecs
  kernels  the fused-step kernel against its plain PyTorch version at the
           bench shape (B=8192, 128->64->64->4), full and ragged/masked
           batches, and at a wider layer set (bc=128, nl=3, C=8); a 5-step
           chain against the exact autograd oracle; the kernel's CUDA-event
           time beside its bound and the plain time
  encode   2048x2048x4 12-bit synthetic scene, seed 42, K=5, g=8, e=10,
           base codec lpc: one warm and three timed encodes, each of which
           must launch the kernel exactly epochs x steps = 5120 times
  determinism  the timed encodes' streams are byte-identical
  decode   three timed decodes; MSBs exact; PSNR
  rd       fused-kernel encode vs exact-step (use_fused=False) encode of the
           same scene and seed: PSNR within 0.1 dB
Then the kernels line, the card line, and the final status line.  Exits
non-zero without a result when CUDA is absent or the package is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, stdout=subprocess.PIPE, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# peak rates for the bound (NVIDIA data sheets, dense, at the full power
# limit): f32 on the CUDA cores and HBM bandwidth
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12)}


def peaks(name: str):
    return PEAKS["pcie" if "PCIE" in name.upper() else "sxm"]


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
        # tolerances of tests/test_fused_step.py; only summation order differs
        torch.testing.assert_close(kl, pl, rtol=1e-5, atol=0)
        for a, r in zip(km.leaves() + kv.leaves(), pm.leaves() + pv.leaves()):
            torch.testing.assert_close(a, r, rtol=1e-3, atol=1e-10)
        # params: the first Adam step moves each by ~lr*g/(|g|+eps), whose
        # sensitivity to g is lr*eps/(|g|+eps)^2 — ill-conditioned for
        # |g| < 1e-6, where a last-bit difference in the gradient sum moves
        # the param by up to 2*lr (bench.py's sign-flip bound).  Elements
        # with |g| >= 1e-6 are held to the tests' tolerance.
        n_ill, err = 0, 0.0
        for a, r, m in zip(kp.leaves(), pp.leaves(), pm.leaves()):
            well = (m.abs() / (1 - fs.ADAM_B1)) >= 1e-6
            torch.testing.assert_close(a[well], r[well], rtol=2e-4, atol=1e-6)
            assert float((a - r).abs().max()) <= 2 * 1e-3
            n_ill += int((~well).sum())
            err = max(err, float((a - r).abs().max()))
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
    plain_ms = cuda_ms(
        lambda: fs.fused_train_step_plain(tp, tm, tv, x, y, mask, 1e-3, 1, mspec, C), 30)
    dims = [F] + [w.shape[1] for w in params0.weights]
    P = sum(w.numel() + b.numel() for w, b in zip(params0.weights, params0.biases))
    ops, nbytes = step_cost(B, dims, P)
    peak_ops, peak_bw = peaks(card)
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / peak_bw * 1e3
    kernel = {
        "name": "fused_train_step", "route": "cuda",
        "source": "lbdrn_msic_tpu_torch/csrc/fused_step.cu",
        "replaces": "lbdrn_msic_tpu/ops/fused_step.py:245",
        "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }
    emit({"phase": "kernels", "cases": cases, "chain_losses": losses,
          "chain_param_drift": drift, "ops": ops, "bytes": nbytes,
          "ms": ms, "plain_ms": plain_ms, "bound_ms": kernel["bound_ms"],
          "card": card})
    return kernel


def phase_profile(img, cfg, secs):
    """One more encode under torch.profiler: device time by kernel name and
    the device's busy share of the encode's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lbdrn_msic_tpu_torch.codec import encode_image

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        encode_image(img, cfg)
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
    busy = sum(r[0] for r in rows) / 1e6
    emit({"phase": "profile", "wall_s_profiled": wall, "wall_s_unprofiled": min(secs),
          "device_busy_s": busy, "device_busy_share": busy / wall,
          "top": [{"kernel": k[:80], "device_ms": us / 1e3, "calls": n}
                  for us, k, n in rows[:12]]})


def phase_codec(profile: bool, kernel):
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch.codec import decode_stream, encode_image
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.eval.metrics import psnr
    from lbdrn_msic_tpu_torch.ops.fused_step import fused_train_step
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
        fused_train_step.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        stream, stats = encode_image(img, cfg)
        secs.append(time.time() - t0)
        launches.append(fused_train_step.launches)
        streams.append(stream)
    assert launches == [n_steps] * 3, (launches, n_steps)
    kernel["launches"] = launches[0]
    emit({"phase": "encode", "shape": [4, H, W], "warm_s": warm_s, "seconds": secs,
          "mpx_s": [mpx / s for s in secs], "phases": stats.phases,
          "bpsp": stats.bpsp, "best_epoch": stats.tiles[0].best_epoch,
          "best_mse": stats.tiles[0].best_mse, "launches": launches,
          "expected_launches": n_steps})

    if profile:
        phase_profile(img, cfg, secs)

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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels",), default=None)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one encode with torch.profiler")
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

    t0 = time.time()
    _build.load("fused_step")
    k_s = time.time() - t0
    t0 = time.time()
    assert _native.load() is not None, "native codec library did not build"
    n_s = time.time() - t0
    ptxas = _build.build_log.get("fused_step", {}).get("ptxas", "")
    emit({"phase": "build", "kernel_s": k_s, "native_s": n_s,
          "ptxas": [ln for ln in ptxas.splitlines() if "registers" in ln or "spill" in ln]})

    kernel = phase_kernels(card)
    if args.only != "kernels":
        phase_codec(args.profile, kernel)
    emit({"kernels": [kernel]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
