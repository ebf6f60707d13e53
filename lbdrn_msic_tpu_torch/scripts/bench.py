"""Headline benchmark of the port: end-to-end codec throughput on one card,
the counterpart of bench.py.

    python -m lbdrn_msic_tpu_torch.scripts.bench [--device cuda|cpu]

Workload (bench.py's): a synthetic 2048x2048x4-band 12-bit scene (seed 42)
at the reference default config K=5, D=2, bc=64, nl=2, lr=1e-3, bs=8192,
e=10, sample_granule=8 and the default `jp2` base codec.  In order:

1. warm-up: one `encode_image`, one `encode_rate_points` (K in {3, 4, 5,
   6}) and one `decode_stream`, inside a `BuildLog` (`warmup_s`; each
   library's build or stamp-load seconds are `compile_s`);
2. `fused_parity_check`: five fused steps (K1 on the card) against the
   exact autograd step;
3. five timed encodes (best and median), three sweeps and three two-scene
   dataset encodes (scenes 42 and 43 x the four K, one `encode_dataset`
   call; per point), three decodes (best and median);
4. the asserts: MSBs exact, parity true, and the exact-step encode
   (`use_fused=False`) within 0.1 dB of the fused one.

Prints a `[bench]` line and the build log to stderr, then ONE JSON line to
stdout, last: bench.py's keys plus `device` (the card's name, count and
power limit as nvidia-smi reports them; "cpu" and no power limit on the
CPU).  `--device` defaults to cuda; the run stops without CUDA unless given
`--device cpu`, and a jp2 run without OpenCV stops before training
(`base_layer.require_cv2`).

Baseline derivation (REF_BASELINE_MPX_S), bench.py's: the reference
publishes no wall-clock numbers (BASELINE.md) and its stack
(fpzip/GDAL/CUDA-torch/ignite) is not part of this repository, so the
baseline is a bound of a CPU host running its data loader, derived from its
own hot-loop structure:

- Its DataLoader serves 8192 per-pixel rows per batch through Python
  __getitem__ + default collate (reference LBDRNdataset.py:151-155,
  encode.py:69-70).  Measured on a CPU host (torch 2.13, single thread):
  59.7 ms/batch.  With the reference's num_workers=32 scaling perfectly,
  the data path alone sustains <= 32/0.0597 ~= 536 batches/s.
- Per image it consumes 512 batches x 10 train epochs + 512 x 10 eval
  passes (evaluator.run(train_loader) every epoch, encode.py:104-106)
  = 10240 batches => >= 19.1 s of data-path time per 4.19-Mpx scene.
- Plus serial host stages the loader cannot hide: the full (H*W, 104) f32
  feature materialization (~1.7 GB numpy sliding-window, ~3-6 s,
  LBDRNdataset.py:108-130), fpzip weight coding and GDAL JP2 base coding
  (~1-2 s, encode.py:124-137).

Floor: >= ~22 s/image = <= 0.19 Mpixels/s even with a GPU fast enough to
be entirely hidden.  REF_BASELINE_MPX_S = 0.30 keeps the older, generous
estimate (a ~1.6x faster host than measured) so `vs_baseline` under-claims
rather than over-claims.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from lbdrn_msic_tpu_torch.core.config import ModelSpec
from lbdrn_msic_tpu_torch.models.siren import init_params, pad_dim
from lbdrn_msic_tpu_torch.ops.fused_step import fused_train_step, reference_train_step

REF_BASELINE_MPX_S = 0.30
# the parity check's batch: bench.py's B rows of the bench widths' features
PARITY_B, PARITY_DIM_IN, PARITY_C = 2048, 100, 4


def parity_inputs(device, seed: int = 0):
    """(params, x, y, mask) of the parity check on `device`: SIREN init
    from a seeded generator, x ~ U(-1, 1) on the real columns with zero
    padding, y ~ U(0, 1), every row counted."""
    gen = torch.Generator().manual_seed(seed)
    padded = pad_dim(PARITY_DIM_IN)
    params = init_params(gen, PARITY_DIM_IN, PARITY_C, ModelSpec(), pad_input_to=padded)
    x = torch.zeros((PARITY_B, padded))
    x[:, :PARITY_DIM_IN] = torch.rand((PARITY_B, PARITY_DIM_IN), generator=gen) * 2 - 1
    y = torch.rand((PARITY_B, PARITY_C), generator=gen)
    mask = torch.ones(PARITY_B)
    return params.to(device), x.to(device), y.to(device), mask.to(device)


def step_chain(step, params, x, y, mask, n_steps: int, lr: float):
    """n_steps of `step` (in place, as the port's steps are) on a clone of
    `params` with its own zero Adam state: (final params, (n_steps,) losses)."""
    p = params.map(torch.clone)
    m, v = p.map(torch.zeros_like), p.map(torch.zeros_like)
    losses = []
    for t in range(1, n_steps + 1):
        p, m, v, loss = step(p, m, v, x, y, mask, lr, t, ModelSpec(), PARITY_C)
        losses.append(loss.reshape(()).clone())
    return p, torch.stack(losses)


def fused_parity_check(device, n_steps: int = 5, lr: float = 1e-3) -> bool:
    """The fused step (K1 on the card; its plain version on the CPU) tracks
    the exact autograd step (`reference_train_step`) over a chain of steps
    from one state, with bench.py's bounds: the per-step losses agree
    within rtol 1e-4, atol 1e-6, and the largest per-leaf parameter
    difference stays below 3 * n_steps * lr (an early Adam step moves a
    parameter by ~lr * sign(grad), so a near-zero gradient whose sign
    differs between the two products moves it by 2 * lr; a wrong product,
    gradient or accumulator diverges by O(1)).  Each chain steps its own
    clone of the parameters: the steps work in place."""
    params, x, y, mask = parity_inputs(device)
    pf, lf = step_chain(fused_train_step, params, x, y, mask, n_steps, lr)
    pr, lref = step_chain(reference_train_step, params, x, y, mask, n_steps, lr)
    ok = bool(torch.allclose(lf, lref, rtol=1e-4, atol=1e-6))
    drift = max(float((a - b).abs().max()) for a, b in zip(pf.leaves(), pr.leaves()))
    return ok and drift < 3.0 * n_steps * lr


def device_info(device) -> dict:
    """The run's device: the card's name and power limit as nvidia-smi
    reports them and the CUDA device count, or "cpu" and no power limit."""
    if device.type != "cuda":
        return {"name": "cpu", "count": 1, "power_limit": None}
    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, stdout=subprocess.PIPE, text=True, timeout=60,
    ).stdout.strip().splitlines()
    name, limit = rows[device.index or 0].rsplit(",", 1)
    return {"name": name.strip(), "count": torch.cuda.device_count(),
            "power_limit": limit.strip()}


def run(device, size: int = 2048, epochs: int = 10, encode_repeats: int = 5,
        repeats: int = 3, seed: int = 42, base_codec=None) -> dict:
    """bench.py's workload on `device` at size x size: {"line": the JSON
    line's dict, and the unrounded measurements behind it}.  `base_codec`
    None is the config's default (jp2); "lpc" codes the base with the
    native coder.  Prints the [bench] line and the build log to stderr."""
    from lbdrn_msic_tpu_torch import resolve_device
    from lbdrn_msic_tpu_torch.codec import (decode_stream, encode_dataset, encode_image,
                                            encode_rate_points)
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.eval.metrics import psnr
    from lbdrn_msic_tpu_torch.utils.build_log import BuildLog
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene

    device = resolve_device(device)
    codec = {} if base_codec is None else {"base_codec": base_codec}

    def config(K):
        return CodecConfig(K=K, train=TrainSpec(sample_granule=8, epochs=epochs), **codec)

    def timed(fn):
        # every call ends on host bytes or a host array: no work queued by
        # the previous call is charged to the next one
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.time()
        out = fn()
        return out, time.time() - t0

    H = W = size
    img = synth_scene(H, W, channels=4, effective_bits=12, seed=seed)
    mpx = H * W / 1e6
    cfg = config(5)
    cfgs = [config(K) for K in (3, 4, 5, 6)]

    with BuildLog() as bl:
        t0 = time.time()
        stream, _ = encode_image(img, cfg, device=device)
        encode_rate_points(img, cfgs, device=device)
        decode_stream(stream, device=device)
        warm = time.time() - t0

    parity = fused_parity_check(device)

    enc_samples = []
    for _ in range(encode_repeats):
        (stream, stats), s = timed(lambda: encode_image(img, cfg, device=device))
        enc_samples.append(s)
    enc_s, enc_med = min(enc_samples), float(np.median(enc_samples))

    sweep_samples = [timed(lambda: encode_rate_points(img, cfgs, device=device))[1] / len(cfgs)
                     for _ in range(repeats)]
    sweep_s = min(sweep_samples)

    img2 = synth_scene(H, W, channels=4, effective_bits=12, seed=seed + 1)
    ds_jobs = [(im, c) for im in (img, img2) for c in cfgs]
    ds_samples = [timed(lambda: encode_dataset(ds_jobs, device=device))[1] / len(ds_jobs)
                  for _ in range(repeats)]
    ds_s = min(ds_samples)

    dec_samples = []
    for _ in range(repeats):
        (rec, _), s = timed(lambda: decode_stream(stream, device=device))
        dec_samples.append(s)
    dec_s, dec_med = min(dec_samples), float(np.median(dec_samples))

    p = psnr(img, rec)
    assert np.array_equal(rec >> cfg.K, img >> cfg.K), "MSB path corrupted"
    assert parity, "the fused step diverged from the exact autograd step"

    # end to end: the fused-step encode and the exact-step encode must land
    # the same rate-distortion point
    (stream_x, stats_x), exact_s = timed(
        lambda: encode_image(img, cfg, use_fused=False, device=device))
    p_x = psnr(img, decode_stream(stream_x, device=device)[0])
    assert abs(p - p_x) < 0.1, (p, p_x)

    phases = " ".join(f"{k}={v:.2f}s" for k, v in sorted((stats.phases or {}).items()))
    print(
        f"[bench] single-image {enc_s:.2f}s (median {enc_med:.2f}) | "
        f"sweep {sweep_s:.2f}s/pt | dataset {ds_s:.2f}s/pt | "
        f"decode {dec_s:.2f}s (median {dec_med:.2f}) | warm-up {warm:.1f}s | "
        f"PSNR {p:.2f} dB (exact-step {p_x:.2f}) bpsp {stats.bpsp:.3f} | "
        f"fused-parity {parity} | {phases}",
        file=sys.stderr,
    )
    print(bl.report(), file=sys.stderr)

    value = mpx / enc_s
    line = {
        "metric": "encode_throughput_single_image",
        "value": round(value, 4),
        "unit": "Mpixels/s/chip",
        "vs_baseline": round(value / REF_BASELINE_MPX_S, 2),
        "median_mpx_s": round(mpx / enc_med, 4),
        "sweep_mpx_s_per_point": round(mpx / sweep_s, 4),
        "dataset_mpx_s_per_point": round(mpx / ds_s, 4),
        "decode_mpx_s": round(mpx / dec_s, 4),
        "decode_median_mpx_s": round(mpx / dec_med, 4),
        "warmup_s": round(warm, 1),
        "compile_s": {name: {"seconds": round(e["seconds"], 2), "rebuilt": e["rebuilt"]}
                      for name, e in sorted(bl.events.items())},
        "fused_parity": parity,
        "psnr_db": round(p, 2),
        "bpsp": round(stats.bpsp, 4),
        "device": device_info(device),
    }
    return {"line": line, "psnr_db": p, "psnr_exact_step_db": p_x, "bpsp": stats.bpsp,
            "bpsp_exact_step": stats_x.bpsp, "exact_step_encode_s": exact_s,
            "encode_s": enc_samples, "sweep_s_per_point": sweep_samples,
            "dataset_s_per_point": ds_samples, "decode_s": dec_samples, "warmup_s": warm,
            "phases": stats.phases}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; the run stops when CUDA is "
                        "absent unless --device cpu is given)")
    args = p.parse_args(argv)

    from lbdrn_msic_tpu_torch.cli.common import device_from_args

    device = device_from_args(args)
    # the exact step and the parity check's reference take full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(run(device)["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
