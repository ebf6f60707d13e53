"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py              # every phase (needs one CUDA card)
    python3 chip_smoke.py --only kernels
    python3 chip_smoke.py --only cli   # encode/decode and cli phases only
    python3 chip_smoke.py --only dataset   # the dataset and sweep_cli phases only
    python3 chip_smoke.py --only flagship  # the staging, tiles and flagship phases only
    python3 chip_smoke.py --only validation  # the multi_k and validation phases only
    python3 chip_smoke.py --only mesh  # the mesh phase only (its references made anew)
    python3 chip_smoke.py --only bench  # the bench phase only
    python3 chip_smoke.py --profile    # adds torch.profiler breakdowns of
                                       # one encode, one sweep, the fit at
                                       # multi_k 0 and 16, one epoch of the
                                       # GF-2 "full" / "banded" encodes and
                                       # one dataset encode

Phases, one JSON line each (every phase asserts; nothing is caught):
  env      card name and power limit, TF32 switched off
  build    nvcc build of csrc/fused_step.cu and g++ build of the host codecs
  kernels  K1, the fused-step kernel, against its plain PyTorch version at
           the bench shape (B=8192, 128->64->64->4), full and ragged/masked
           batches, at a wider layer set (bc=128, nl=3, C=8) and at the
           coordinate features' input width (150 -> F_pad 256; timed beside
           its bound as `coords_f256`); a 5-step
           chain against the exact autograd oracle; at the ablation matrix's
           shapes (ABLATION_WIDTHS: bc=128 nl=1, bc=128 nl=2, bc=256 nl=2,
           F = 196 / 36 / 4 / 2, B = 2048 / 4096) one step against the plain
           step, a 5-step chain against the oracle, rows a CTA, weights
           staged or not, time, bound and plain time; the kernel's CUDA-event
           time beside its bound and the plain time; each pass's device
           time by kernel name (a torch.profiler window over 50 steps; pass
           2 is a programmatic dependent launch whose span opens during pass
           1, so the line also gives the step's time less pass 1's); the
           design csrc/fused_step.cu fixes (no clusters, FFMA products)
  kernels_experts  K2, the expert step (same source, an expert grid axis),
           at the sweep's shape (E=4, B=8192): against its plain version,
           and bit for bit against K1 on each expert's slices, full,
           ragged with per-expert masks, at the wider layer set, and at the
           coordinate width (150 -> F_pad 256) with per-expert masks; time,
           pass split and design as for K1, bound, plain time; time and
           bound also at E = 8 (`e8`, the dataset cell's), at E = 2 (`e2`, a
           rank's share of the mesh phase's ep = 2 sweep, also held against
           its plain version and K1 per expert as case `mesh_ep2_e2`) and at
           F_pad 256 (`coords_f256`); at the ablation sweeps' E = 6 (K 1..6) for the
           bench widths and each expert-compatible ABLATION_WIDTHS shape:
           against the plain step, bit for bit K1 per expert, time, bound
           and plain time
  encode   2048x2048x4 12-bit synthetic scene, seed 42, K=5, g=8, e=10,
           base codec lpc: one warm and three timed encodes, each of which
           must launch K1 exactly epochs x steps = 5120 times (and K2 never)
  determinism  the timed encodes' streams are byte-identical
  decode   three timed decodes (the base's four row chunks through the
           streamed lpc path, "dispatch_pipelined"), interleaved with three
           through the plain path (the whole base decoded, then the band
           dispatch), bit for bit equal; MSBs exact; PSNR
  rd       (after the bench line) the decode phase's PSNR vs the bench
           phase's exact-step (use_fused=False) encode of the same scene
           and seed (jp2 base): within 0.1 dB
  sweep    the rate sweep of the same scene, K in {3, 4, 5, 6}, "full" tap
           staging: one timed `encode_rate_points` (the bench phase times
           three), which must launch K2 exactly 5120 times (and K1 never);
           each point's stream byte for byte `encode_image`'s at its K (so
           deterministic), decoded (MSBs exact), PSNR within 0.1 dB of it
  bench    the port's bench.py, `scripts.bench.run("cuda")` at its defaults
           (the encode cell's scene and config with the jp2 base codec: one
           warm-up encode, sweep and decode, the fused parity check, five
           timed encodes, three sweeps, three two-scene dataset encodes,
           three decodes, the exact-step encode), the counts zeroed just
           before it: K1 exactly 5 + 6 x 5120 launches and K2 exactly 4 x
           5120 + 3 x 5120 (the dataset one chunk of E = 8); parity true;
           its line's keys, its unrounded PSNR (in the full run equal to the
           decode phase's to 1e-9: the base codec changes the stream, not
           the residuals), seconds, peak device memory and the card line
  kernels_multi  K3 (k steps of K1 in one persistent cooperative launch)
           and K4 (of K2), same source: K3 at k=16, B=8192; ragged/masked
           with a schedule and step0=3; wide; K4 at E=4, k=8, full and
           wide.  Each step at K1's tolerances against the plain step from
           the same state, the whole chunk at trajectory tolerance against
           the plain k steps, every launch bit for bit k chained K1 / K2
           launches, K4's expert e bit for bit K3; time per launch and per
           step, k chained single-step launches, bound, plain time
  multi_k  `profiling.multik_ab` (`fit`, K=5, one eval, at multi_k in {0,
           4, 16, 64}) and `fit_rate_experts` (K in {3, 4, 5, 6}) at {0, 8,
           32} on the same scene: one warm and two
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
           (b) a GF-2-sized scene (7605x7815x4, 12-bit, seed 42, e=1):
           `encode_image` at K=5 and K=3 must pick "full" at the card's
           staging budget, and K=3 "banded" at the JAX package's budget,
           each launching K1 exactly 1 x 7256 = 7256 times (K2 never),
           decoded with MSBs exact, K=3 "full" within 0.1 dB of "banded";
           (c) its rate sweep, K in {3, 4, 5, 6}, one group, at either
           budget: "full" and "banded", each exactly 7256 K2 launches (K1
           never), every point decoded with MSBs exact, K=3 byte-identical
           to (b)'s K=3 stream of the same staging, the full sweep's K=5 to
           (b)'s K=5, the banded sweep's K=5 within 0.1 dB of it.  Seconds,
           staged bytes against `_staging_bytes`' estimate, peak device
           memory allocated and reserved (each GF-2 run's at most
           PEAK_LIMIT_GB, 64 GB), sha256; with --profile, one epoch of the
           "full" K=5 and "banded" K=3 encodes under the profiler
  kernel_prof  K5, the nine step-anatomy probes of
           profiling/kernel_prof.py: each variant's kernel against its plain
           version from the same state, one step and a 5-step chain, at a
           tolerance per product (f32, TF32, 3xTF32, bf16); fwd_notrans
           leaves params bit-unchanged, full_t is full_dg bit for bit,
           tile2048 agrees with full_dg to summation order; then the
           profiling path itself, variant by variant with the counts
           zeroed before it: three 512-step runs (median device time)
           beside the bound and the plain time, and the launches it made;
           each variant's design, product route (ffma, wgmma_tf32,
           wgmma_3xtf32), rows a CTA and time less prod_f32's in the same
           call (the anatomy reading); ptxas registers and spills of every
           K5 instantiation and of K1's step_partials / multi_step from the
           build log, and the HGMMA / HMMA counts of K5's SASS (cuobjdump):
           the wgmma variants must issue HGMMA and no K5 kernel mma.sync
  cli      the command lines, each `main(argv)` called in this process on
           the bench scene written as a TIFF (the port's write_tiff) with the
           bench flags -K 5 -g 8 --base-codec lpc: (a) cli.encode launches K1
           exactly 5120 times (K2 never) and writes the encode phase's stream
           byte for byte; cli.decode -org --keep-recon logs the decode
           phase's PSNR and bpsp (read back through scrape_log), MSBs exact;
           cli.summarize writes the CSV row; a second cli.encode prints
           "Bitstream already created!" and launches nothing; (b) --bucket on
           the top-left 1900x2000 crop (bucket 2048x2048): 10 x 512 = 5120
           launches bucketed, 10 x 464 = 4640 exact, both decoded MSB-exact,
           PSNRs within 0.1 dB; (c) --use-coords --embedding ("cached", F =
           150, F_pad 256, the rows per CTA cta_layout chose) and with
           --no-colors (F = 50, F_pad 128): 5120 launches each, decoded
           through the full-plane path MSB-exact, PSNR, bpsp, the decode's
           peak device memory; (d) --header-version 0 --trace DIR: the body
           after the 15-byte header is (a)'s, the stream decodes MSB-exact,
           the torch.profiler trace names K1's kernels, --compile-log logs
           its compile line.  Seconds of each run and each encode log's
           phases
  dataset  the dataset workload (`encode_dataset`), each run with the counts
           zeroed before it: (a) bench.py's dataset cell, scenes 42 and 43 x K
           in {3, 4, 5, 6}, one timed run (the bench phase times three),
           exactly 5120 K2 launches at E = 8 and no K1, every stream
           `encode_image`'s byte for byte (so deterministic); (b)
           bucket=True on scene 42 and its 1900x2000 crop: one chunk, 5120
           K2 launches with (E, B) masks, the crop's streams
           `encode_image(bucket=True)`'s (else within 0.1 dB); (c) both
           scenes at K=5: the pipelined path, 2 x 5120 K1 launches,
           `encode_image`'s bytes, seconds against two `encode_image`
           calls; (d) a coordinate sweep of scene 42 (F_pad 256): 5120 K2
           launches, each point `encode_image`'s.  Then
           `decode_pipelined_iter` over all 22 streams, bit for bit
           `decode_stream`, MSBs exact, the colour-only ones through the
           streamed lpc path ("dispatch_pipelined") and bit for bit the
           plain path; seconds a stream
  sweep_cli  `cli.sweep --batch-experts -g 8 --base-codec lpc --k-min 3
           --k-max 6` on both scenes as TIFFs: 5120 K2 launches, (a)'s
           streams, the decode logs' PSNR the dataset decode's; a second run
           launches nothing; --pipeline and the per-job path on scene 42 at
           K 5..6: 2 x 5120 K1 launches each, the same bytes
  tiles    split_ratio 2, each run with the counts zeroed before it: (a) the
           bench scene, four 1024^2 "cached" tiles, with the double-buffering
           gate open (tiles 2-4 uploaded on a side stream while the one before
           trains) and forced shut, in the order open, shut, shut, open: 5120
           K1 launches each, the streams byte-identical, the decode
           MSB-exact, both orders' seconds; (b) the staging phase's GF-2
           scene at e=1, four "cached" tiles, the gate open and shut in the
           same order: epochs x steps summed over the tiles (7257) K1
           launches, MSB-exact, seconds and peak device memory (allocated
           and reserved, at most 64 GB) beside split_ratio 1's "full" K=5
           encode
  flagship `scripts.flagship_workload.run` on GF2_D (7605x7815x4, the
           staging phase's GF-2 scene, not made twice), WFI_A
           (6000^2x8) and PMS_A (6000^2x4) at K 3..6, e=1: bucketed
           `encode_dataset` a scene, `decode_pipelined_iter`, summarize, the
           Baseline CSV, the BD table; every stream MSB-lossless, the
           chunks of experts [4] (GF2_D), [3, 1] (WFI_A) and [4] (PMS_A) at
           the card's staging budget, each scene's encode peaks (allocated
           and reserved) at most 64 GB, K2 launched epochs x steps per
           chunk summed over the chunks (K1 never), each scene's K=5
           stream `encode_image(bucket=True)`'s byte for byte (else within
           0.1 dB), those three streams'
           pipelined decode bit for bit `decode_stream`, BD-PSNR > 0 and
           BD-Rate < 0 against Baseline in every group; staging, chunks,
           seconds a job per group, peak device memory per scene
  validation  the reference's validation studies through the port's
           scripts, each run with the counts zeroed before it:
           rd_validation at its defaults (512^2, 3 scenes, K 1..6, e=10:
           exactly 18 x 10 x 32 K1 launches, every stream MSB-exact, the
           JPEG 2000 anchors, BD-Rate < 0 and BD-PSNR > 0 against
           Baseline); substitute_anchors at its defaults; recipe_study's
           four recipes (18 x epochs x 32 K1 launches each, BD against
           ref_e10, seconds a job); the ablation matrix at its defaults
           (256^2, 2 scenes, four groups, 23 variants: each variant's K1 /
           K2 launches exactly epochs x steps per fit, MSB-exact, BD
           against its group's anchor) and its network group at the bench
           scene (2048^2, e=2, K2 at E = 6 through bc=256, 2 x 512 = 1024
           launches a variant); the multi_k phase's multik_ab rows.
           Whether OpenCV is present, and what its absence left out
  mesh     multi-card parallelism on the one card: a world of 2 processes,
           both on cuda:0 over gloo (started by the script, joined with a
           timeout), each with the launch counts zeroed just before each
           run and read just after: the ep = 2 rate sweep of the bench scene
           at K 3..6 (K2 at E = 2 on each rank, 5120 launches each, every
           stream the sweep phase's byte for byte), the dp = 2 encode at K=5,
           e=2 (the exact step with the gradients summed over the ranks, no
           K1: the same stream on both ranks, MSB-exact, within 0.1 dB of a
           single-card fused encode at e=2) and the sp = 2 decode of the
           encode phase's stream (bit for bit the single-card decode); per rank its
           seconds, launches, peak device memory and backend; then a world
           of 1 over NCCL runs the collective helper on CUDA tensors.
           Multi-card NCCL is not verified (one card)
Every phase line carries `total_seconds`, its wall seconds.  Then the
whole script's seconds and each phase's (`phase_seconds`), the kernels
line (K1-K4, K5 per variant; K1's and K2's launches_by_path per path), the
card line, and the final status line.  Exits non-zero without
a result when CUDA is absent or the
package is missing.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time


# thread-block cluster size and f32 product routine of csrc/fused_step.cu's
# first pass, fixed in the source (PERF.md has the times of the others)
FUSED_STEP_DESIGN = {"cluster": 1, "product": "ffma"}
# the device functions of K1-K4 (csrc/fused_step.cu), by kernel name
FUSED_STEP_KERNELS = ("step_partials", "step_adam", "multi_step")
K1_KERNELS = FUSED_STEP_KERNELS[:2]  # one K1 step's two passes


# each phase line's wall seconds (its own `total_seconds`, else the time
# since the phase line before it or the start of main): the total line's
# phase_seconds
PHASE_SECONDS = {}
_phase_mark = [time.time()]


def emit(obj) -> None:
    """Print obj as one JSON line.  A phase line other than the total line
    gains `total_seconds` unless it has its own, and enters PHASE_SECONDS."""
    if "phase" in obj and obj["phase"] != "total":
        now = time.time()
        name = obj["phase"] if obj["phase"] != "profile" else f"profile_{obj['of']}"
        PHASE_SECONDS[name] = obj.setdefault("total_seconds", now - _phase_mark[0])
        _phase_mark[0] = now
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


# the ablation matrix's shapes (scripts/ablations.py's variants) that no
# other case runs: (case, B, (bc, nl), input width F), C = 4.  nl=1 has no
# hidden-to-hidden layer; bc=128, nl=2 and bc=256 read their weights from
# global memory (cta_layout); D=3's 196 pads to 256; D=1, absolute colours
# at D=0 and coordinates alone (K1 only: not expert-compatible) pad to 128
ABLATION_WIDTHS = (
    ("bc128_nl1", 8192, (128, 1), 100),
    ("bc128_nl2", 8192, (128, 2), 100),
    ("bc256_nl2", 8192, (256, 2), 100),
    ("d3_f196", 8192, (64, 2), 196),
    ("d1_f36", 8192, (64, 2), 36),
    ("abs_d0_f4", 8192, (64, 2), 4),
    ("coords_f2", 8192, (64, 2), 2),
    ("bs2048", 2048, (64, 2), 100),
    ("bs4096", 4096, (64, 2), 100),
)
# K2 at the sweep's E = 6 (K 1..6): the bench widths and every shape above
# that a rate sweep trains as experts
ABLATION_WIDTHS_E6 = (("bc64_nl2", 8192, (64, 2), 100),) + tuple(
    w for w in ABLATION_WIDTHS if w[0] != "coords_f2")

# the 8-band WFI scenes' feature width (25 a band at the default
# features): F_pad 256 beside C = 8, the flagship's K2 shape
WFI_D_IN = 200


def phase_kernels(card: str):
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec
    from lbdrn_msic_tpu_torch.models.siren import init_params, pad_dim
    from lbdrn_msic_tpu_torch.ops import fused_step as fs

    mspec = ModelSpec()
    C, dim_in, B = 4, 100, 8192
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    assert FeatureSpec().feature_dim(8) == WFI_D_IN

    def inputs(b, masked, c=C, d_in=dim_in):
        x = np.zeros((b, pad_dim(d_in)), np.float32)
        x[:, :d_in] = rng.uniform(-1, 1, (b, d_in))
        y = (1 / (1 + np.exp(-rng.standard_normal((b, c))))).astype(np.float32)
        mask = np.ones(b, np.float32)
        if masked:
            mask[rng.random(b) < 0.2] = 0.0
        return [torch.from_numpy(a).to(dev) for a in (x, y, mask)]

    def init(spec, c, d_in=dim_in):
        return init_params(torch.Generator().manual_seed(0), d_in, c, spec,
                           pad_input_to=pad_dim(d_in), device=dev)

    clone = lambda p: p.map(torch.clone)

    def check(name, b, masked, spec, c, d_in):
        """One K1 step against the plain one from the same state: (the
        case's row, the initial params and the batch)."""
        x, y, mask = inputs(b, masked, c, d_in)
        p0 = init(spec, c, d_in)
        z0 = p0.map(torch.zeros_like)
        kp, km, kv = clone(p0), clone(z0), clone(z0)
        pp, pm, pv = clone(p0), clone(z0), clone(z0)
        _, _, _, kl = fs.fused_train_step(kp, km, kv, x, y, mask, 1e-3, 1, spec, c)
        _, _, _, pl = fs.fused_train_step_plain(pp, pm, pv, x, y, mask, 1e-3, 1, spec, c)
        torch.cuda.synchronize()
        err, n_ill = check_step((kp, km, kv), kl, (pp, pm, pv), pl)
        rows, staged = fs.cta_layout([pad_dim(d_in)] + [w.shape[1] for w in p0.weights],
                                     fs._smem_optin)
        return ({"case": name, "B": b, "F_pad": pad_dim(d_in),
                 "widths": [spec.base_channel, spec.num_layers, c],
                 "rows_per_cta": rows, "weights_in_smem": staged,
                 "loss": float(kl), "loss_plain": float(pl),
                 "max_abs_err_params": err, "params_with_grad_below_1e-6": n_ill},
                p0, (x, y, mask))

    # the bench widths, full and ragged/masked; one wider layer set (bc=128,
    # nl=3, C=8), whose weights do not fit in shared memory beside a CTA's
    # rows, so the kernel reads them from global memory; the coordinate
    # features' input width (150 -> F_pad 256, 32 rows a CTA) of the cli
    # phase; and the 8-band WFI scenes' shape at the bench widths (F = 200
    # -> F_pad 256, C = 8) of the flagship's encode_image checks, whole
    # and under a bucket's pad mask
    full, params0, batch = check("full", B, False, mspec, C, dim_in)
    cases = [full] + [check(*case)[0] for case in (
        ("ragged_masked", B - 37, True, mspec, C, dim_in),
        ("wide_ragged_masked", 1000, True, ModelSpec(128, 3), 8, dim_in),
        ("coords_embedding_masked", B, True, mspec, C, 150),
        ("wfi_c8_f256", B, False, mspec, 8, WFI_D_IN),
        ("wfi_c8_f256_masked", B, True, mspec, 8, WFI_D_IN))]

    def chain(spec, c, p0, x, y, mask, n_steps=5, lr=1e-3):
        """n K1 steps against the exact autograd oracle (bench.py's bounds):
        (losses, largest param drift)."""
        z0 = p0.map(torch.zeros_like)
        kp, km, kv = clone(p0), clone(z0), clone(z0)
        rp, rm, rv = clone(p0), clone(z0), clone(z0)
        losses = []
        for t in range(1, n_steps + 1):
            _, _, _, kl = fs.fused_train_step(kp, km, kv, x, y, mask, lr, t, spec, c)
            _, _, _, rl = fs.reference_train_step(rp, rm, rv, x, y, mask, lr, t, spec, c)
            torch.testing.assert_close(kl, rl, rtol=1e-4, atol=1e-6)
            losses.append([float(kl), float(rl)])
        drift = max(float((a - r).abs().max()) for a, r in zip(kp.leaves(), rp.leaves()))
        assert drift < 3 * n_steps * lr, drift
        return losses, drift

    def timed(spec, c, d_in, b=B, masked=False, n=300):
        """K1's and the plain step's ms a step at these widths, and the bound
        (a kernel_entry); the state keeps training (lr is irrelevant)."""
        x, y, m = inputs(b, masked, c, d_in)
        p0 = init(spec, c, d_in)
        z0 = p0.map(torch.zeros_like)
        tp, tm, tv = clone(p0), clone(z0), clone(z0)
        step = lambda f: f(tp, tm, tv, x, y, m, 1e-3, 1, spec, c)
        P = sum(w.numel() + bb.numel() for w, bb in zip(p0.weights, p0.biases))
        ops, nbytes = step_cost(b, [pad_dim(d_in)] + [w.shape[1] for w in p0.weights], P)
        entry = kernel_entry("", "", card, ops, nbytes,
                             cuda_ms(lambda: step(fs.fused_train_step), n),
                             cuda_ms(lambda: step(fs.fused_train_step_plain), 30), 0.0)
        return entry, (lambda: step(fs.fused_train_step)), ops, nbytes

    losses, drift = chain(mspec, C, params0, *batch)

    # the ablation matrix's widths (ABLATION_WIDTHS): one step against the
    # plain step, a 5-step chain against the oracle, time, bound, plain time
    widths = []
    for name, b, (bc, nl), d_in in ABLATION_WIDTHS:
        spec = ModelSpec(bc, nl)
        row, p0, batch = check(name, b, False, spec, C, d_in)
        entry = timed(spec, C, d_in, b, n=100)[0]
        widths.append({**row, "F": d_in, "chain_param_drift": chain(spec, C, p0, *batch)[1],
                       **{key: entry[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")}})

    # timing at the bench shape, at the coordinate features' width (the cli
    # phase's (c)) and at the WFI scenes' (C = 8, F_pad 256, a bucket's pad
    # mask)
    kernel, run, ops, nbytes = timed(mspec, C, dim_in)
    passes = pass_times(run)
    kernel.update(name="fused_train_step", replaces="lbdrn_msic_tpu/ops/fused_step.py:245",
                  max_abs_err=max(r["max_abs_err_params"] for r in cases + widths))
    coords = timed(mspec, C, 150)[0]
    wfi = timed(mspec, 8, WFI_D_IN, masked=True)[0]
    ms, plain_ms = kernel["ms"], kernel["plain_ms"]
    emit({"phase": "kernels", "cases": cases, "chain_losses": losses,
          "chain_param_drift": drift, "ops": ops, "bytes": nbytes,
          "ms": ms, "passes": passes, "pass_2_after_pass_1_ms": ms - pass1_ms(passes),
          "design": FUSED_STEP_DESIGN, "plain_ms": plain_ms,
          "bound_ms": kernel["bound_ms"],
          "coords_f256": {k: coords[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
          "wfi_c8_f256": {k: wfi[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
          "ablation_widths": widths, "card": card})
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
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    clone = lambda p: p.map(torch.clone)

    def inputs(b, densities, c, d_in=dim_in, n_exp=E):
        """(n_exp, b) batches; one shared (b,) mask of ones (as in the
        sweep), or per-expert masks of the given densities."""
        x = np.zeros((n_exp, b, pad_dim(d_in)), np.float32)
        x[..., :d_in] = rng.uniform(-1, 1, (n_exp, b, d_in))
        y = (1 / (1 + np.exp(-rng.standard_normal((n_exp, b, c))))).astype(np.float32)
        if densities is None:
            mask = np.ones(b, np.float32)
        else:
            mask = np.stack([rng.random(b) < d for d in densities]).astype(np.float32)
        return [torch.from_numpy(a).to(dev) for a in (x, y, mask)]

    def init(spec, c, d_in=dim_in, n_exp=E):  # a different network per expert
        return stack_params([init_params(torch.Generator().manual_seed(e), d_in, c, spec,
                                         pad_input_to=pad_dim(d_in))
                             for e in range(n_exp)]).to(dev)

    def check(name, b, dens, spec, c, d_in, n_exp):
        """One K2 step against the plain one from the same state, and
        expert e bit for bit K1 on expert e's slices: the case's row."""
        x, y, mask = inputs(b, dens, c, d_in, n_exp)
        p0 = init(spec, c, d_in, n_exp)
        z0 = p0.map(torch.zeros_like)
        k = (clone(p0), clone(z0), clone(z0))
        p = (clone(p0), clone(z0), clone(z0))
        *_, kl = fs.fused_expert_step(*k, x, y, mask, 1e-3, 1, spec, c)
        *_, pl = fs.fused_expert_step_plain(*p, x, y, mask, 1e-3, 1, spec, c)
        torch.cuda.synchronize()
        err, n_ill = check_step(k, kl, p, pl)
        for e in range(n_exp):
            one = tuple(unstack_params(st, e).map(torch.clone) for st in (p0, z0, z0))
            *_, l1 = fs.fused_train_step(*one, x[e], y[e], mask[e] if mask.dim() == 2 else mask,
                                         1e-3, 1, spec, c)
            torch.cuda.synchronize()
            assert torch.equal(kl[e], l1), (name, e)
            for st2, st1 in zip(k, one):
                for a, r in zip(unstack_params(st2, e).leaves(), st1.leaves()):
                    assert torch.equal(a, r), (name, e)
        rows, staged = fs.cta_layout([pad_dim(d_in)] + [w.shape[-1] for w in p0.weights],
                                     fs._smem_optin)
        return {"case": name, "E": n_exp, "B": b, "F_pad": pad_dim(d_in),
                "widths": [spec.base_channel, spec.num_layers, c],
                "mask_densities": dens, "rows_per_cta": rows, "weights_in_smem": staged,
                "loss": kl.tolist(), "loss_plain": pl.tolist(),
                "max_abs_err_params": err, "params_with_grad_below_1e-6": n_ill,
                "bit_identical_to_k1_per_expert": True}

    # the sweep's shape, full; ragged with per-expert masks (the bucketed
    # dataset's (E, B) masks); the wide layer set; the coordinate
    # features' width (150 -> F_pad 256) with per-expert masks, the
    # coordinate sweep's (the dataset phase's (d)); and the WFI scenes'
    # shape at the bench widths (F = 200 -> F_pad 256, C = 8) with bucket
    # pad masks: E = 1 with a (1, B) mask, as the flagship's one-expert
    # chunks run it (WFI_A's last), E = 3 (WFI_A's first chunk) and E = 4
    cases = [check(name, b, dens, spec, c, d_in, E if dens is None else len(dens))
             for name, b, dens, spec, c, d_in in (
                 ("full", B, None, mspec, C, dim_in),
                 ("ragged_per_expert_masks", B - 37, (1.0, 0.8, 0.5, 0.2), mspec, C, dim_in),
                 ("wide_ragged_per_expert_masks", 1000, (1.0, 0.8, 0.5, 0.0), ModelSpec(128, 3),
                  8, dim_in),
                 ("coords_f256_per_expert_masks", B - 37, (1.0, 0.8, 0.5, 0.2), mspec, C, 150),
                 ("wfi_c8_f256_e1_mask", B, (0.95,), mspec, 8, WFI_D_IN),
                 ("wfi_c8_f256_e3_masks", B, (0.95, 0.9, 0.8), mspec, 8, WFI_D_IN),
                 ("wfi_c8_f256_per_expert_masks", B, (0.95, 0.8, 0.5, 0.2), mspec, 8,
                  WFI_D_IN))]
    # the mesh phase's ep = 2 sweep: each rank's K2 at E = 2
    cases.append(check("mesh_ep2_e2", B, None, mspec, C, dim_in, 2))

    def timed(n_exp, d_in, densities, c=C, spec=mspec, b=B, n=300):
        """K2's and its plain version's ms a step, and the bound, at
        (n_exp, b, pad_dim(d_in)) and c channels; the state keeps
        training (lr is irrelevant)."""
        x, y, mask = inputs(b, densities, c, d_in, n_exp)
        tp = init(spec, c, d_in, n_exp)
        tm, tv = tp.map(torch.zeros_like), tp.map(torch.zeros_like)
        step = lambda f: f(tp, tm, tv, x, y, mask, 1e-3, 1, spec, c)
        ms = cuda_ms(lambda: step(fs.fused_expert_step), n)
        plain = cuda_ms(lambda: step(fs.fused_expert_step_plain), 30)
        P = sum(w[0].numel() + bb[0].numel() for w, bb in zip(tp.weights, tp.biases))
        ops, nbytes = step_cost(b, [pad_dim(d_in)] + [w.shape[-1] for w in tp.weights], P)
        entry = kernel_entry("", "", card, n_exp * ops, n_exp * nbytes, ms, plain, 0.0)
        return entry, (lambda: step(fs.fused_expert_step)), n_exp * ops, n_exp * nbytes

    # the ablation matrix's rate sweeps: E = 6 (K 1..6), one shared mask
    widths = []
    for name, b, (bc, nl), d_in in ABLATION_WIDTHS_E6:
        spec = ModelSpec(bc, nl)
        row = check(name, b, None, spec, C, d_in, 6)
        entry = timed(6, d_in, None, C, spec, b, n=100)[0]
        widths.append({**row, **{key: entry[key]
                                 for key in ("ms", "plain_ms", "bound_ms", "bound_by")}})

    kernel, run, ops, nbytes = timed(E, dim_in, None)  # the sweep's shape
    passes = pass_times(run)
    kernel.update(name="fused_expert_step", replaces="lbdrn_msic_tpu/ops/fused_step.py:765",
                  max_abs_err=max(r["max_abs_err_params"] for r in cases + widths))
    # the dataset cell's E = 8, and the coordinate sweep's F_pad 256 with
    # per-expert masks
    e8 = timed(8, dim_in, None)[0]
    e2 = timed(2, dim_in, None)[0]  # a rank's share of the ep = 2 sweep
    f256 = timed(E, 150, (1.0, 0.8, 0.5, 0.2))[0]
    # the flagship's WFI chunks (E = 1, C = 8, F_pad 256, a pad mask), and E = 4
    wfi1 = timed(1, WFI_D_IN, (0.95,), 8)[0]
    wfi4 = timed(E, WFI_D_IN, (0.95, 0.8, 0.5, 0.2), 8)[0]
    pick = lambda k: {key: k[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")}
    emit({"phase": "kernels_experts", "cases": cases, "E": E, "ops": ops,
          "bytes": nbytes, "ms": kernel["ms"], "passes": passes,
          "pass_2_after_pass_1_ms": kernel["ms"] - pass1_ms(passes), "design": FUSED_STEP_DESIGN,
          "plain_ms": kernel["plain_ms"], "bound_ms": kernel["bound_ms"],
          "e8": pick(e8), "e2": pick(e2), "coords_f256": pick(f256), "wfi_c8_f256_e1": pick(wfi1),
          "wfi_c8_f256_e4": pick(wfi4), "ablation_widths_e6": widths, "card": card})
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
    """`fit` and `fit_rate_experts` at the bench shape with multi_k:
    `profiling.multik_ab` (the fit at multi_k in {0, 4, 16, 64}, one warm
    and two timed rounds, interleaved) and the expert fit at {0, 8, 32}
    likewise; every run with the counts zeroed before it: exact launch
    counts, every chunked fit bit-identical to its multi_k=0 fit."""
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch.codec import plan_rate_points, tile_generator
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.ops import fused_step as fs
    from lbdrn_msic_tpu_torch.profiling import multik_ab
    from lbdrn_msic_tpu_torch.train.loop import fit_rate_experts
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene
    from lbdrn_msic_tpu_torch.utils.transfer import put_image

    H = W = 2048
    C, K = 4, 5
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=42)
    train = TrainSpec(sample_granule=8, epochs=10)
    Ks = (3, 4, 5, 6)
    cfgs = [CodecConfig(K=k, base_codec="lpc", train=train) for k in Ks]
    cfg = cfgs[Ks.index(K)]
    fit_k, steps = multik_ab.bench_fit()
    dev_img = put_image(img, torch.device("cuda"))
    _, dtypes, _, _ = plan_rate_points(img, cfgs)
    kernels = (fs.fused_train_step, fs.fused_expert_step, fs.fused_multi_step,
               fs.fused_expert_multi_step)

    def sweep_k(k):
        return fit_rate_experts(dev_img, Ks, tile_generator(train.seed, 0), cfg.features,
                                cfg.model, train, H, W, C, tap_dtypes=dtypes, multi_k=k)

    def counted(run, k, runs):
        """run(k) with the four counts zeroed just before it; appends (k,
        result, counts) to runs."""
        for kern in kernels:
            kern.launches = 0
        res = run(k)
        torch.cuda.synchronize()
        runs.append((k, res, [kern.launches for kern in kernels]))
        return res

    out = {}
    for what, run, ks, single, multi in (("fit", fit_k, multik_ab.VARIANTS, 0, 2),
                                         ("sweep", sweep_k, (0, 8, 32), 1, 3)):
        runs = []
        samples = multik_ab.ab(lambda k: counted(run, k, runs), ks)
        ref = runs[0][1]
        for k, res, counts in runs:
            want = [0, 0, 0, 0]
            if k:
                want[multi] = train.epochs * -(-steps // k)
            else:
                want[single] = train.epochs * steps
            assert counts == want, (what, k, counts, want)
            assert same_fit(res, ref), (what, k, "chunked fit differs from multi_k=0")
        base = float(np.median(samples[0]["seconds"]))
        out[what] = [{"multi_k": k, "seconds": samples[k]["seconds"],
                      "launches": counts[multi] if k else counts[single],
                      "kernel": kernels[multi if k else single].__name__,
                      "best_mse": samples[k]["best_mse"], "identical_to_multi_k_0": True,
                      "median_s_vs_multi_k_0": float(np.median(samples[k]["seconds"])) / base}
                     for k, res, counts in runs[-len(ks):]]
    k3["launches"] = out["fit"][2]["launches"]  # at k = 16, as timed in kernels_multi
    k4["launches"] = out["sweep"][1]["launches"]  # at k = 8
    emit({"phase": "multi_k", "shape": [C, H, W], "steps_per_epoch": steps,
          "epochs": train.epochs, "fit_K": K, "fit": "profiling.multik_ab.bench_fit",
          "sweep_Ks": list(Ks), **out, "card": card})

    if profile:
        for row in out["fit"][:3:2]:  # multi_k 0 and 16
            phase_profile(f"fit multi_k={row['multi_k']}", lambda: fit_k(row["multi_k"]),
                          row["seconds"])
    return out["fit"]


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
        if mode.startswith("prod"):
            design = {"design": "k1", "instantiation": None}
        else:
            design = {"design": kp.DESIGN, "instantiation": K5_INSTANTIATIONS[name]}
        timing.append({"variant": name, "product": product, "route": kp.route(name),
                       **design, "rows_per_cta": kp.cta_rows(name),
                       "ms_512_steps": ms_run, "ms_512_steps_runs": runs,
                       "ms_per_step": ms_run / kp.STEPS,
                       "delta_vs_prod_f32_ms": ms_run / kp.STEPS - timing[0]["ms_per_step"]
                       if timing else 0.0,
                       "bound_ms_per_step": entry["bound_ms"], "bound_by": entry["bound_by"],
                       "plain_ms_per_step": plain_ms, "launches": launches,
                       "kernel": "K1" if mode.startswith("prod") else "K5"})
    assert timing[0]["variant"] == "prod_f32"
    # registers and spills from this run's build log; wgmma in K5's SASS
    from lbdrn_msic_tpu_torch.ops import _build

    ptxas = {src: ptxas_table(_build.build_log.get(src, {}).get("ptxas", ""))
             for src in ("kernel_prof", "fused_step")}
    ptxas["fused_step"] = {k: v for k, v in ptxas["fused_step"].items()
                           if k.startswith(("step_partials", "multi_step"))}
    sass = sass_counts(os.path.join(_build.BUILD_DIR, "libkernel_prof.so"))
    if sass is not None:
        for name in ("prec_default", "prec_high"):
            if not sass.get(K5_INSTANTIATIONS[name], {}).get("HGMMA"):
                failed.append(f"{name}: no HGMMA in {K5_INSTANTIATIONS[name]}'s SASS")
        if any(c["HMMA"] for c in sass.values()):
            failed.append("K5's SASS holds mma.sync (HMMA)")
    emit({"phase": "kernel_prof", "B": kp.B, "widths": dims, "checks": checks,
          "full_t_bit_identical_to_full_dg": "full_t != full_dg bit for bit" not in failed,
          "tile2048_vs_full_dg_max_mv_err_over_largest": tile_mv, "timing": timing,
          "ptxas": ptxas, "sass": sass, "failed": failed, "card": card})
    assert not failed, failed
    return kernels


# the pass-1 instantiation of each K5 variant (csrc/kernel_prof.cu kPartials)
K5_INSTANTIATIONS = {
    "full_t": "prof_ffma<0, false, true, false>", "full_dg": "prof_ffma<0, false, false, true>",
    "tile2048": "prof_ffma<0, false, false, true>",
    "fast_full": "prof_ffma<1, false, true, false>", "prec_default": "prof_tc<false>",
    "prec_high": "prof_tc<true>", "fwd_notrans": "prof_ffma<2, true, false, false>"}


def short_names(mangled) -> dict:
    """{mangled: demangled name with its template arguments and without its
    namespace and parameters} through c++filt (the mangled name where c++filt
    is missing)."""
    mangled = list(mangled)
    tool = shutil.which("c++filt")
    if not tool or not mangled:
        return {m: m for m in mangled}
    out = subprocess.run([tool], input="\n".join(mangled), stdout=subprocess.PIPE, text=True,
                         timeout=60).stdout.splitlines()
    names = {}
    for m, d in zip(mangled, out):
        d = d.split("(anonymous namespace)::")[-1]
        names[m] = d[:d.index("(")] if "(" in d else d
    return names


def ptxas_table(text: str) -> dict:
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads"}} from
    `nvcc -Xptxas -v` output (the build log of a library built in this run)."""
    table, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = m.group(1)
            table[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            table[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            table[cur]["registers"] = int(m.group(1))
    names = short_names(table)
    return {names[k]: v for k, v in table.items()}


def sass_counts(lib: str):
    """{kernel: {"HGMMA": n, "HMMA": n}} of a built library's SASS
    (cuobjdump -sass), or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib], stdout=subprocess.PIPE, text=True,
                          timeout=300, check=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            counts[cur] = {"HGMMA": 0, "HMMA": 0}
        elif cur:
            counts[cur]["HGMMA"] += "HGMMA" in ln
            counts[cur]["HMMA"] += bool(re.search(r"\bHMMA\b", ln))
    names = short_names(counts)
    return {names[k]: v for k, v in counts.items()}


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


@contextlib.contextmanager
def replaced(module, name, fn, result=None):
    """A context in which module.name is fn; it yields `result`."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield result
    finally:
        setattr(module, name, real)


def recording(module, name, calls):
    """A context in which module.name records each call's keyword
    arguments before making it; it yields `calls`."""
    real = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(k)
        return real(*a, **k)

    return replaced(module, name, wrapped, calls)


def plain_decode_path():
    """A context in which `decode_stream` takes the plain path for a
    row-chunked lpc base too: the whole base decoded, then
    `dispatch_streamed`'s bands (the streamed path declines)."""
    from lbdrn_msic_tpu_torch.decode import reconstruct

    return replaced(reconstruct, "dispatch_streamed_lpc", lambda *a, **k: None)


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

    # the streamed lpc path (the stream's base has 4 row chunks), and the
    # plain path it must equal bit for bit, interleaved
    dsecs, psecs = [], []
    for _ in range(3):
        t0 = time.time()
        rec, dstats = decode_stream(streams[0])
        dsecs.append(time.time() - t0)
        with plain_decode_path():
            t0 = time.time()
            rec_plain, pstats = decode_stream(streams[0])
            psecs.append(time.time() - t0)
        assert np.array_equal(rec, rec_plain), "streamed lpc decode differs from the plain path"
    assert "dispatch_pipelined" in dstats.phases, dstats.phases
    assert "base_decode" in pstats.phases, pstats.phases
    assert rec.shape == img.shape and rec.dtype == np.uint16
    assert np.array_equal(rec >> cfg.K, img >> cfg.K), "MSB path corrupted"
    p = psnr(img, rec)
    emit({"phase": "decode", "seconds": dsecs, "mpx_s": [mpx / s for s in dsecs],
          "phases": dstats.phases, "psnr_db": p, "bpsp": stats.bpsp,
          "plain_path": {"seconds": psecs, "mpx_s": [mpx / s for s in psecs],
                         "phases": pstats.phases, "bit_identical_to_streamed": True},
          "jax_package_rd_point": {"psnr_db": 61.79, "bpsp": 1.958,
                                   "source": "BENCH_r05.json"}})
    return {"stream": streams[0], "psnr_db": p, "bpsp": stats.bpsp, "img": img}


def phase_rd(encoded, bench_rec):
    """The fused encode's PSNR (the decode phase's) against the bench
    phase's exact-step (use_fused=False) encode of the same scene and
    config (`bench_rec`): within 0.1 dB.  The bench codes the base with
    jp2, which changes the stream, not the residuals; the bpsp pair is
    the bench's."""
    p = encoded["psnr_db"]
    assert abs(p - bench_rec["psnr_exact_step_db"]) < 0.1, (p, bench_rec["psnr_exact_step_db"])
    emit({"phase": "rd", "shape": list(encoded["img"].shape), "psnr_fused_db": p,
          "base_codec": "jp2", "bpsp_fused": bench_rec["bpsp"],
          **{k: bench_rec[k] for k in ("psnr_exact_step_db", "bpsp_exact_step",
                                       "exact_step_encode_s")}})


def phase_sweep(profile: bool, kernel):
    import numpy as np

    from lbdrn_msic_tpu_torch.codec import (
        decode_stream, encode_image, encode_rate_points, plan_rate_points)
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.eval.metrics import psnr
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

    # one timed sweep (the bench phase times three): each stream held byte
    # for byte against encode_image's, which a nondeterministic run fails
    res, sec, launches, peak_gb = counted_run(lambda: encode_rate_points(img, cfgs))
    secs = [sec]
    assert launches == [0, n_steps], (launches, n_steps)
    kernel["launches"] = launches[1]
    kernel["launches_by_path"] = {"sweep": launches[1]}

    points, solos = [], []
    for cfg, (stream, stats) in zip(cfgs, res):
        rec, _ = decode_stream(stream)
        assert rec.shape == img.shape and np.array_equal(rec >> cfg.K, img >> cfg.K), cfg.K
        solo, solo_stats = encode_image(img, cfg)
        solos.append(solo)
        assert solo == stream, ("sweep stream differs from encode_image's", cfg.K)
        p, p_solo = psnr(img, rec), psnr(img, decode_stream(solo)[0])
        assert abs(p - p_solo) < 0.1, (cfg.K, p, p_solo)
        points.append({"K": cfg.K, "psnr_db": p, "bpsp": stats.bpsp,
                       "best_epoch": stats.tiles[0].best_epoch,
                       "best_mse": stats.tiles[0].best_mse,
                       "identical_to_encode_image": True,
                       "sha256": hashlib.sha256(stream).hexdigest(),
                       "psnr_encode_image_db": p_solo, "bpsp_encode_image": solo_stats.bpsp})
    emit({"phase": "sweep", "shape": [4, H, W], "Ks": list(Ks), "staging": staging,
          "tap_dtypes": [str(d).replace("torch.", "") for d in dtypes],
          "staged_tap_bytes": sum(staged), "seconds": secs,
          "mpx_s_per_point": [mpx * len(Ks) / s for s in secs],
          "phases": res[0][1].phases, "launches": [launches[1]], "expected_launches": n_steps,
          "deterministic": True, "peak_device_gb": peak_gb, "points": points})

    if profile:
        phase_profile("sweep", lambda: encode_rate_points(img, cfgs), secs)
    return {K: solo for K, solo in zip(Ks, solos)}, [s for s, _ in res]


def phase_bench(k1, k2, decode_psnr=None):
    """`scripts.bench.run` at its defaults, counted; `decode_psnr`: the
    decode phase's PSNR, which the bench's must equal.  Returns the run's
    record."""
    from lbdrn_msic_tpu_torch.scripts import bench

    n_steps = 10 * -(-(-(-2048 * 2048 // 8)) // (8192 // 8))
    # K1: the parity check's five steps, the warm-up and five timed encodes;
    # K2: the warm-up and three timed sweeps, three dataset runs
    want = [5 + 6 * n_steps, 4 * n_steps + 3 * n_steps]
    rec, secs, launches, peak = counted_run(lambda: bench.run("cuda"))
    line = rec["line"]
    assert launches == want, (launches, want)
    assert line["fused_parity"] is True
    if decode_psnr is not None:
        assert abs(rec["psnr_db"] - decode_psnr) <= 1e-9, (rec["psnr_db"], decode_psnr)
    k1["launches_by_path"]["bench"] = launches[0]
    k2["launches_by_path"]["bench"] = launches[1]
    emit({"phase": "bench", **line, "psnr_db_unrounded": rec["psnr_db"],
          "psnr_exact_step_db": rec["psnr_exact_step_db"], "bpsp_unrounded": rec["bpsp"],
          "psnr_minus_decode_phase_db": (None if decode_psnr is None
                                         else rec["psnr_db"] - decode_psnr),
          "encode_s": rec["encode_s"], "sweep_s_per_point": rec["sweep_s_per_point"],
          "dataset_s_per_point": rec["dataset_s_per_point"], "decode_s": rec["decode_s"],
          "encode_phases": rec["phases"], "launches_k1": launches[0],
          "launches_k2": launches[1], "expected_launches": want, "seconds": secs,
          "peak_gb": peak, "card": card_line(),
          "jax_package_rd_point": {"psnr_db": 61.79, "bpsp": 1.958, "source": "BENCH_r05.json"}})
    return rec


def same_fit(a, b) -> bool:
    """Two fits bit for bit: step losses, best MSE and epoch, best params."""
    import torch

    return (torch.equal(a.step_losses, b.step_losses) and a.best_epoch == b.best_epoch
            and a.best_mse == b.best_mse
            and all(torch.equal(x, y) for x, y in zip(a.params.leaves(), b.params.leaves())))


def counted_run(fn, fresh=False):
    """fn() with the K1 / K2 launch counts zeroed just before it and read
    just after, and the device's peak memory over it: (result, seconds,
    [K1, K2] launches, peak GB).  `fresh` first returns the allocator's
    cached blocks to the card, so that the peak reserved bytes read just
    after are the run's own."""
    import torch

    from lbdrn_msic_tpu_torch.ops.fused_step import fused_expert_step, fused_train_step

    fused_train_step.launches = fused_expert_step.launches = 0
    torch.cuda.synchronize()
    if fresh:
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.time() - t0, [fused_train_step.launches, fused_expert_step.launches],
            torch.cuda.max_memory_allocated() / 1e9)


# the most device memory, allocated or reserved, a Gaofen-sized run may
# peak at: 80 % of the card's 80 GB, the margin the staging budget
# (`codec.STAGE_BUDGET_BYTES`, half the card) is sized to keep
PEAK_LIMIT_GB = 64.0
# the JAX package's staging budget, under which the GF-2 scene's K=3
# encode and rate sweep still stage "banded" at the real size
JAX_STAGE_BUDGET_BYTES = 8 << 30


def gaofen_run(fn):
    """`counted_run(fn, fresh=True)` for a Gaofen-sized run, its peaks
    allocated and reserved held to PEAK_LIMIT_GB: (result, seconds,
    launches, peak allocated GB, peak reserved GB)."""
    import torch

    out, secs, launches, peak = counted_run(fn, fresh=True)
    reserved = torch.cuda.max_memory_reserved() / 1e9
    assert max(peak, reserved) <= PEAK_LIMIT_GB, (peak, reserved)
    return out, secs, launches, peak, reserved


# the GF-2-sized runs' epochs (the staging phase's encodes and sweep, the
# tiles phase's four split_ratio 2 encodes): below the codec's 10 to keep
# the script inside its time with the validation, mesh and bench phases;
# the per-epoch work and the staging plans are those of e=10
GF2_EPOCHS = 1


def phase_staging(profile: bool, k1, k2):
    """Training above the feature-cache budget: (a) `fit` in each forced
    mode at the bench scene against "cached"; (b) GF-2-sized encodes that
    `pick_staging` routes to "full" (K=5 and K=3) at the card's budget and
    to "banded" (K=3) at the JAX package's, decoded; (c) the GF-2 rate
    sweep, "full" at the card's budget and "banded" at the JAX package's.
    One run each; every GF-2 run's peaks, allocated and reserved, held to
    PEAK_LIMIT_GB."""
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch import codec
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
    # 7605x7815x4, 12-bit) at the bench config, e=GF2_EPOCHS: above the
    # cache budget
    t0 = time.time()
    H, W = 7605, 7815
    big = synth_scene(H, W, channels=C, effective_bits=12, seed=42, fast=True)
    synth_s = time.time() - t0
    train = TrainSpec(sample_granule=8, epochs=GF2_EPOCHS)
    mx = int(big.max())

    def budget(b):
        """The card's staging budget (None), or `b` in its place."""
        return (contextlib.nullcontext() if b is None
                else replaced(codec, "STAGE_BUDGET_BYTES", b))

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

    # K=5 and K=3 "full" at the card's budget; K=3 "banded" at the JAX
    # package's, the one GF-2 encode that still stages row taps
    encodes, streams, dec = [], {}, {}
    for K_, want, b in ((5, "full", None), (3, "full", None),
                        (3, "banded", JAX_STAGE_BUDGET_BYTES)):
        cfg = CodecConfig(K=K_, base_codec="lpc", train=train)
        with budget(b):
            (stream, stats), secs, launches, peak, reserved = gaofen_run(
                lambda: encode_image(big, cfg))
        tile = stats.tiles[0]
        steps = _batch_geometry(train, H, W, want).steps
        assert tile.staging == want and steps == 7256, (K_, tile.staging, steps)
        assert launches == [train.epochs * steps, 0], (K_, launches)
        streams[(K_, want)] = stream
        row = {"K": K_, "staging": tile.staging,
               "budget_bytes": b or codec.STAGE_BUDGET_BYTES, "seconds": secs,
               "phases": stats.phases, "launches_k1": launches[0], "launches_k2": launches[1],
               "staged_bytes": tile.staged_bytes, "staged_bytes_estimate": estimate(cfg, want),
               "peak_device_gb": peak, "peak_reserved_gb": reserved,
               "best_epoch": tile.best_epoch, "best_mse": tile.best_mse, "bpsp": stats.bpsp,
               "sha256": hashlib.sha256(stream).hexdigest()}
        dec[(K_, want)] = decoded(stream, K_)
        row.update(dec[(K_, want)])
        encodes.append(row)
        k1["launches_by_path"][f"gf2_encode_k{K_}_{want}"] = launches[0]
    # K=3 "full" against "banded": W % 8 != 0, so the granule grids differ
    # and the networks with them: RD-equivalent only
    k3_full_minus_banded_db = dec[(3, "full")]["psnr_db"] - dec[(3, "banded")]["psnr_db"]
    assert abs(k3_full_minus_banded_db) < 0.1, k3_full_minus_banded_db
    b_s = time.time() - t0

    # (c) the GF-2 rate sweep, one group: "full" at the card's budget, then
    # "banded" at the JAX package's
    t0 = time.time()
    Ks = (3, 4, 5, 6)
    cfgs = [CodecConfig(K=k, base_codec="lpc", train=train) for k in Ks]
    sweeps = {}
    for want, b in (("full", None), ("banded", JAX_STAGE_BUDGET_BYTES)):
        with budget(b):
            staging, dtypes, groups, per_expert = plan_rate_points(big, cfgs)
            assert staging == want and groups == [[0, 1, 2, 3]], (want, staging, groups)
            res, secs, launches, peak, reserved = gaofen_run(
                lambda: encode_rate_points(big, cfgs))
        assert launches == [0, train.epochs * 7256], (want, launches)
        k2["launches_by_path"][f"gf2_sweep_{want}"] = launches[1]
        points = []
        for cfg, (stream, stats) in zip(cfgs, res):
            assert stats.tiles[0].staging == want
            pt = {"K": cfg.K, "bpsp": stats.bpsp, "best_epoch": stats.tiles[0].best_epoch,
                  "best_mse": stats.tiles[0].best_mse,
                  "sha256": hashlib.sha256(stream).hexdigest()}
            same = streams.get((cfg.K, want)) == stream
            # a point whose stream is an encode's decodes as that encode did
            pt.update(dec[(cfg.K, want)] if same else decoded(stream, cfg.K))
            pt[f"identical_to_{want}_encode"] = same
            points.append(pt)
        by_k = {p["K"]: p for p in points}
        # K=3: the encode of the same staging, so the same network and bytes
        assert res[Ks.index(3)][0] == streams[(3, want)], f"{want} sweep K=3 differs"
        sweeps[want] = {
            "Ks": list(Ks), "staging": staging, "budget_bytes": b or codec.STAGE_BUDGET_BYTES,
            "dtypes": [str(d).replace("torch.", "") for d in dtypes],
            "seconds": secs, "phases": res[0][1].phases, "launches_k1": launches[0],
            "launches_k2": launches[1], "staged_bytes": res[0][1].tiles[0].staged_bytes,
            "staged_bytes_estimate": sum(per_expert), "peak_device_gb": peak,
            "peak_reserved_gb": reserved, f"k3_identical_to_{want}_encode": True,
            "points": points}
        del res
    # K=5: "full" on both sides for the full sweep (the same bytes); the
    # banded sweep's K=5 draws another granule grid (W % 8 != 0), RD only
    assert sweeps["full"]["points"][Ks.index(5)]["identical_to_full_encode"]
    d5 = sweeps["banded"]["points"][Ks.index(5)]["psnr_db"] - dec[(5, "full")]["psnr_db"]
    assert abs(d5) < 0.1, d5
    sweeps["banded"]["k5_psnr_vs_full_encode_db"] = d5
    c_s = time.time() - t0
    emit({"phase": "staging", "bench_forced_modes": forced,
          "gf2": {"shape": [C, H, W], "synth": "synth_scene(fast=True), seed 42",
                  "synth_s": synth_s, "epochs": train.epochs, "steps_per_epoch": 7256,
                  "budget_bytes": codec.STAGE_BUDGET_BYTES,
                  "jax_budget_bytes": JAX_STAGE_BUDGET_BYTES,
                  "peak_limit_gb": PEAK_LIMIT_GB, "encodes": encodes,
                  "k3_full_minus_banded_psnr_db": k3_full_minus_banded_db,
                  "sweep": sweeps["full"], "sweep_banded": sweeps["banded"]},
          "phase_seconds": {"a_forced_modes": a_s, "b_gf2_encodes": b_s, "c_gf2_sweeps": c_s,
                            "total": time.time() - t_phase}})

    if profile:  # one epoch of the GF-2 fit in each mode: staging, batch assembly, K1
        for K_, want, b in ((5, "full", None), (3, "banded", JAX_STAGE_BUDGET_BYTES)):
            cfg = CodecConfig(K=K_, base_codec="lpc", train=TrainSpec(sample_granule=8, epochs=1))
            with budget(b):
                secs = counted_run(lambda: encode_image(big, cfg))[1]
                phase_profile(f"gf2 encode e=1 {want}", lambda: encode_image(big, cfg), [secs])
    return {"big": big, "k5_full": encodes[0]}


def phase_cli(k1, encoded, img, crop_hw=(1900, 2000)):
    """The command lines on `img` (the bench scene), written as a TIFF,
    with the bench flags (-K 5 -g 8 --base-codec lpc; e=10, bs=8192, D=2
    by default), each CLI's `main(argv)` called in this process on the
    card: (a) encode -> decode -> summarize, the stream byte for byte the
    encode phase's (`encoded`); (b) --bucket on the top-left `crop_hw` crop
    against its exact shape; (c) coordinate features (F_pad 256, and 128
    without colours); (d) --header-version 0 with --trace.  One run each;
    every check asserts."""
    import csv
    import glob
    import io
    import re
    import tempfile

    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch.cli import decode as decode_cli
    from lbdrn_msic_tpu_torch.cli import encode as encode_cli
    from lbdrn_msic_tpu_torch.cli import summarize as summarize_cli
    from lbdrn_msic_tpu_torch.codec import bucket_dims, pick_staging
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, FeatureSpec, TrainSpec
    from lbdrn_msic_tpu_torch.eval.metrics import psnr
    from lbdrn_msic_tpu_torch.io.header import header_size
    from lbdrn_msic_tpu_torch.io.tiff import read_tiff, write_tiff
    from lbdrn_msic_tpu_torch.models.siren import pad_dim
    from lbdrn_msic_tpu_torch.ops import fused_step as fs
    from lbdrn_msic_tpu_torch.train.loop import _batch_geometry
    from lbdrn_msic_tpu_torch.utils.logging import scrape_log

    t_phase = time.time()
    bench = ["-K", "5", "-g", "8", "--base-codec", "lpc"]
    run_tail = "_r1_K5_bc64_nl2_D2_prec16_lr0.001_bs8192_e10_g8"
    train = TrainSpec(sample_granule=8)
    C, H, W = img.shape
    steps = lambda h, w: train.epochs * _batch_geometry(train, h, w).steps  # K1 launches
    tmp = tempfile.mkdtemp(prefix="cli_")
    quiet = io.StringIO()  # the CLIs' log lines (also in their log files)

    def cli(main, argv):
        with contextlib.redirect_stdout(quiet):
            return main(argv)

    def tif(name, arr):
        path = os.path.join(tmp, name + ".tif")
        write_tiff(path, arr)
        return path

    def encode(path, out, *flags):
        """One encode CLI run: (run dir, stream, seconds, [K1, K2] launches,
        its log's phases)."""
        rc, secs, launches, _ = counted_run(
            lambda: cli(encode_cli.main, ["-i", path, "-o", out, *bench, *flags]))
        assert rc == 0, rc
        stem = os.path.splitext(os.path.basename(path))[0]
        run_dir = glob.glob(os.path.join(out, stem + "_r1_*"))[0]
        log = open(os.path.join(run_dir, "encode.txt")).read()
        phases = dict(re.findall(r"(\w+)=([\d.]+)s", log.split("phases: ")[1].splitlines()[0]))
        with open(os.path.join(run_dir, stem + ".bin"), "rb") as f:
            stream = f.read()
        return run_dir, stream, secs, launches, {k: float(v) for k, v in phases.items()}

    def decode(run_dir, orig_path, orig, K=5):
        """One decode CLI run (-org, --keep-recon): its scraped log, MSBs
        checked exact, seconds, peak device GB."""
        stem = os.path.basename(run_dir).split("_r1_")[0]
        rc, secs, launches, peak = counted_run(lambda: cli(decode_cli.main, [
            "-i", os.path.join(run_dir, stem + ".bin"), "-org", orig_path, "--keep-recon"]))
        assert rc == 0 and launches == [0, 0], (rc, launches)
        rec = read_tiff(os.path.join(run_dir, stem + "_recon.tif"))
        assert rec.shape == orig.shape and np.array_equal(rec >> K, orig >> K), run_dir
        got = scrape_log(os.path.join(run_dir, "decode.txt"))
        return got, rec, secs, peak

    # (a) the round trip at the bench config
    t0 = time.time()
    scene = tif("scene", img)
    out_a = os.path.join(tmp, "a")
    run_a, stream_a, enc_s, launches, phases_a = encode(scene, out_a)
    assert os.path.basename(run_a) == "scene" + run_tail, run_a
    n_steps = steps(H, W)  # 10 x 512 at 2048^2
    assert launches == [n_steps, 0], launches
    k1["launches_by_path"]["cli"] = launches[0]
    assert stream_a == encoded["stream"], "CLI stream differs from encode_image's"
    got_a, rec_a, dec_s, dec_peak = decode(run_a, scene, img)
    assert got_a["psnr"] == encoded["psnr_db"] and got_a["bpsp"] == encoded["bpsp"], got_a
    assert cli(summarize_cli.main, ["-i", "scene", "-o", out_a, "--k-min", "5", "--k-max", "5",
                                    "-g", "8", "--base-codec", "lpc"]) == 0
    with open(os.path.join(out_a, "results_r1_bc64_nl2_D2_prec16_lr0.001_bs8192_e10_g8.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["K", "scene_MSE", "scene_PSNR", "scene_bpsp", "scene_bits"], rows
    assert float(rows[1][2]) == got_a["psnr"] and int(rows[1][4]) == 8 * len(stream_a), rows
    quiet.seek(0)
    quiet.truncate()
    rc, again_s, again, _ = counted_run(lambda: cli(encode_cli.main, ["-i", scene, "-o", out_a,
                                                                      *bench]))
    assert rc == 0 and again == [0, 0], again
    assert quiet.getvalue().strip() == "Bitstream already created!", quiet.getvalue()
    a = {"seconds": time.time() - t0, "encode_s": enc_s, "encode_phases": phases_a,
         "launches_k1": launches[0], "launches_k2": launches[1],
         "sha256": hashlib.sha256(stream_a).hexdigest(),
         "identical_to_encode_image": True, "decode_s": dec_s, "decode_peak_device_gb": dec_peak,
         "decode_log": got_a, "psnr_equal_to_decode_phase": True, "csv_row": rows[1],
         "resume_s": again_s, "resume_launches": again}

    # (b) --bucket on the top-left crop (1900x2000: bucket 2048x2048, 10 x
    # 512 launches bucketed, 10 x 464 exact)
    t0 = time.time()
    crop = np.ascontiguousarray(img[:, : crop_hw[0], : crop_hw[1]])
    crop_path = tif("crop", crop)
    bucket = bucket_dims(*crop_hw, 2)
    b = {"shape": list(crop.shape), "bucket": list(bucket)}
    for name, flags, want in (("bucketed", ["--bucket"], steps(*bucket)),
                              ("exact", [], steps(*crop_hw))):
        run_dir, stream, secs, launches, phases = encode(crop_path, os.path.join(tmp, name),
                                                         *flags)
        assert launches == [want, 0], (name, launches, want)
        got, _, dsecs, _ = decode(run_dir, crop_path, crop)
        b[name] = {"encode_s": secs, "encode_phases": phases, "launches_k1": launches[0],
                   "psnr_db": got["psnr"], "bpsp": got["bpsp"], "decode_s": dsecs,
                   "sha256": hashlib.sha256(stream).hexdigest()}
        k1["launches_by_path"][f"cli_crop_{name}"] = launches[0]
    b["psnr_diff_db"] = b["bucketed"]["psnr_db"] - b["exact"]["psnr_db"]
    assert abs(b["psnr_diff_db"]) < 0.1, b
    b["seconds"] = time.time() - t0

    # (c) coordinate features: with colours (F = 150, F_pad 256) and without
    # (F = 50, F_pad 128); "cached" staging, the full-plane decode
    t0 = time.time()
    c = []
    for flags in (["--use-coords", "--embedding"],
                  ["--use-coords", "--embedding", "--no-colors"]):
        fspec = FeatureSpec(use_coords=True, embedding=True, use_colors="--no-colors" not in flags)
        F = fspec.feature_dim(C)
        staging, _ = pick_staging(H, W, C, int(img.max()) >> 5, fspec, train)
        assert staging == "cached", (flags, staging)
        rows_cta, staged_w = fs.cta_layout([pad_dim(F), 64, 64, C], fs._smem_optin)
        out = os.path.join(tmp, "c" + str(len(c)))
        run_dir, stream, secs, launches, phases = encode(scene, out, *flags)
        assert launches == [n_steps, 0], (flags, launches)
        got, rec, dsecs, peak = decode(run_dir, scene, img)
        assert abs(got["psnr"] - psnr(img, rec)) < 1e-9
        c.append({"flags": flags, "F": F, "F_pad": pad_dim(F), "staging": staging,
                  "rows_per_cta": rows_cta, "weights_staged": staged_w, "encode_s": secs,
                  "encode_phases": phases, "launches_k1": launches[0], "psnr_db": got["psnr"],
                  "bpsp": got["bpsp"], "decode_s": dsecs, "decode_peak_device_gb": peak,
                  "sha256": hashlib.sha256(stream).hexdigest()})
        k1["launches_by_path"]["cli_coords_F%d" % pad_dim(F)] = launches[0]
    assert [x["F_pad"] for x in c] == [256, 128], c
    c_s = time.time() - t0

    # (d) a v0 header, a torch.profiler trace of the encode and the build log
    t0 = time.time()
    trace_dir = os.path.join(tmp, "trace")
    run_d, stream_d, secs, launches, phases = encode(scene, os.path.join(tmp, "d"),
                                                     "--header-version", "0", "--trace",
                                                     trace_dir, "--compile-log")
    assert launches == [n_steps, 0], launches
    compile_line = re.search(r"compile: [\d.]+s backend over \d+ programs",
                             open(os.path.join(run_d, "encode.txt")).read())
    assert compile_line, "no compile line in the --compile-log encode's log"
    assert stream_d[0] != 0xFF and stream_d[header_size(stream_d):] == \
        stream_a[header_size(stream_a):], "v0 body differs from v1's"
    got_d, _, dsecs, _ = decode(run_d, scene, img)
    traces = glob.glob(os.path.join(trace_dir, "*.json"))
    assert len(traces) == 1, traces
    text = open(traces[0]).read()
    named = {k: text.count(k) for k in K1_KERNELS}
    assert all(named.values()), named
    d = {"encode_s": secs, "encode_phases": phases, "launches_k1": launches[0],
         "header_bytes": header_size(stream_d), "body_identical_to_v1": True,
         "psnr_db": got_d["psnr"], "decode_s": dsecs, "trace_mb": len(text) / 1e6,
         "trace_kernel_mentions": named, "compile_log_line": compile_line.group(0),
         "seconds": time.time() - t0}
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cli", "flags": bench, "a_round_trip": a, "b_bucket": b, "c_coords": c,
          "c_seconds": c_s, "d_v0_trace": d, "total_seconds": time.time() - t_phase})


def phase_dataset(profile: bool, k1, k2, sweep_solos=None):
    """The dataset workload, each `encode_dataset` run with the K1 / K2
    counts zeroed just before it and read just after: (a) bench.py's
    dataset cell, scenes 42 and 43 x K in {3, 4, 5, 6}: one group, one
    chunk of 8 experts on "full" staging; (b) bucket=True on scene 42 and
    its 1900x2000 crop: one chunk with (E, B) masks; (c) both scenes at
    K=5 only: the pipelined path (K1); (d) a coordinate sweep of scene 42
    (F_pad 256).  Every stream is held against `encode_image` at its K
    (`sweep_solos`: the sweep phase's streams of scene 42, else encoded
    here).  Then `decode_pipelined_iter` over every stream against
    `decode_stream`.  Returns the scenes and (a)'s streams."""
    import numpy as np
    import torch

    from lbdrn_msic_tpu_torch import codec
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, FeatureSpec, TrainSpec
    from lbdrn_msic_tpu_torch.eval.metrics import psnr
    from lbdrn_msic_tpu_torch.models.siren import pad_dim
    from lbdrn_msic_tpu_torch.train.loop import _batch_geometry
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene

    t_phase = time.time()
    H = W = 2048
    mpx = H * W / 1e6
    Ks = (3, 4, 5, 6)
    train = TrainSpec(sample_granule=8, epochs=10)
    n_steps = train.epochs * _batch_geometry(train, H, W).steps  # 10 x 512
    cfgs = {K: CodecConfig(K=K, base_codec="lpc", train=train) for K in Ks}
    t0 = time.time()
    scenes = {s: synth_scene(H, W, channels=4, effective_bits=12, seed=s) for s in (42, 43)}
    synth_s = time.time() - t0
    sha = lambda b: hashlib.sha256(b).hexdigest()

    solos, solo_s = {}, {}

    def solo(key, img, cfg, **kw) -> bytes:
        """`encode_image`'s stream for `key` (encoded once, its seconds kept)."""
        if key not in solos:
            (stream, _), secs, launches, _ = counted_run(lambda: codec.encode_image(img, cfg, **kw))
            assert launches == [n_steps, 0], (key, launches)
            solos[key], solo_s[key] = stream, secs
        return solos[key]

    # (a) bench.py's dataset cell (bench.py:183-193), one timed run (the
    # bench phase times three): every stream held byte for byte against
    # encode_image's below, which a nondeterministic run fails
    jobs_a = [(scenes[s], cfgs[K]) for s in (42, 43) for K in Ks]
    res, sec, launches, peak = counted_run(lambda: codec.encode_dataset(jobs_a))
    secs, peaks = [sec], [peak]
    assert launches == [0, n_steps], launches
    plan = res[0][1].plan  # the group's plan, as the encode ran it
    assert plan.staging == "full" and plan.chunks == [list(range(8))], plan
    assert plan.budget == codec.STAGE_BUDGET_BYTES, plan.budget
    streams_a = {(s, K): stream for (s, K), (stream, _) in
                 zip([(s, K) for s in (42, 43) for K in Ks], res)}
    for (s, K), stream in streams_a.items():
        if s == 42 and sweep_solos is not None:
            solos[(42, K)] = sweep_solos[K]
        assert stream == solo((s, K), scenes[s], cfgs[K]), ("a", s, K)
    k2["launches_by_path"]["dataset"] = n_steps
    a = {"jobs": "scenes 42, 43 x K 3..6", "staging": plan.staging,
         "tap_dtypes": [str(d).replace("torch.", "") for d in plan.dtypes],
         "staged_bytes": res[0][1].tiles[0].staged_bytes,
         "staged_bytes_estimate": sum(plan.per_expert), "chunks": plan.chunks,
         "seconds": secs, "seconds_per_point": [x / 8 for x in secs],
         "mpx_s_per_point": [8 * mpx / x for x in secs], "peak_device_gb": peaks,
         "launches_k1": 0, "launches_k2": n_steps, "deterministic": True,
         "identical_to_encode_image": True,
         "points": [{"scene": s, "K": K, "bpsp": st.bpsp, "best_epoch": st.tiles[0].best_epoch,
                     "best_mse": st.tiles[0].best_mse, "sha256": sha(stream)}
                    for (s, K), (stream, st) in zip(streams_a, res)]}
    if profile:
        phase_profile("dataset", lambda: codec.encode_dataset(jobs_a), secs)

    # (b) bucket=True: scene 42 and its crop share the 2048^2 bucket
    crop = np.ascontiguousarray(scenes[42][:, :1900, :2000])
    jobs_b = [(scenes[42], cfgs[K]) for K in Ks] + [(crop, cfgs[K]) for K in Ks]
    with recording(codec, "fit_rate_experts", []) as calls:
        res_b, sec_b, launches, peak_b = counted_run(
            lambda: codec.encode_dataset(jobs_b, bucket=True))
    assert launches == [0, n_steps], launches
    assert len(calls) == 1 and [tuple(h) for h in calls[0]["hws"]] == \
        [(H, W)] * 4 + [(1900, 2000)] * 4, calls
    k2["launches_by_path"]["dataset_bucket"] = n_steps
    b_points = []
    for (img, cfg), (stream, st) in zip(jobs_b, res_b):
        rec, _ = codec.decode_stream(stream)
        assert rec.shape == img.shape and np.array_equal(rec >> cfg.K, img >> cfg.K)
        if img is crop:
            ref = solo(("crop", cfg.K), crop, cfg, bucket=True)
        else:
            ref = streams_a[(42, cfg.K)]
        same = stream == ref
        d_db = 0.0 if same else psnr(img, rec) - psnr(img, codec.decode_stream(ref)[0])
        assert same or abs(d_db) < 0.1, (cfg.K, d_db)
        b_points.append({"image": "crop" if img is crop else "scene42", "K": cfg.K,
                         "identical_to_reference": same, "psnr_db": psnr(img, rec),
                         "psnr_minus_reference_db": d_db, "sha256": sha(stream)})
    b = {"bucket": [H, W], "crop": [1900, 2000], "seconds": sec_b, "peak_device_gb": peak_b,
         "launches_k2": n_steps, "per_expert_masks": True,
         "reference": "crop: encode_image(bucket=True); scene 42: (a)'s stream",
         "points": b_points}

    # (c) one rate point per image: the pipelined path, K1
    jobs_c = [(scenes[s], cfgs[5]) for s in (42, 43)]
    solo((42, 5), scenes[42], cfgs[5])
    solo((43, 5), scenes[43], cfgs[5])
    two_s = []
    for s in (42, 43):  # two encode_image calls, timed in this phase
        (stream, _), sec, _, _ = counted_run(lambda: codec.encode_image(scenes[s], cfgs[5]))
        assert stream == solos[(s, 5)]
        two_s.append(sec)
    res_c, sec_c, launches, _ = counted_run(lambda: codec.encode_dataset(jobs_c))
    assert launches == [2 * n_steps, 0], launches
    assert [r[0] for r in res_c] == [solos[(42, 5)], solos[(43, 5)]], "pipelined != encode_image"
    k1["launches_by_path"]["dataset_pipelined"] = 2 * n_steps
    c = {"jobs": "scenes 42, 43 at K=5", "seconds": sec_c, "encode_image_seconds": two_s,
         "seconds_over_two_encode_images": sec_c / sum(two_s), "launches_k1": 2 * n_steps,
         "identical_to_encode_image": True}

    # (d) a coordinate sweep: K2 at F_pad 256
    fspec = FeatureSpec(use_coords=True, embedding=True)
    cfgs_d = {K: CodecConfig(K=K, base_codec="lpc", train=train, features=fspec) for K in Ks}
    jobs_d = [(scenes[42], cfgs_d[K]) for K in Ks]
    res_d, sec_d, launches, peak_d = counted_run(lambda: codec.encode_dataset(jobs_d))
    assert launches == [0, n_steps], launches
    for (img, cfg), (stream, _) in zip(jobs_d, res_d):
        assert stream == solo(("coords", cfg.K), img, cfg), ("d", cfg.K)
    k2["launches_by_path"]["dataset_coords_f256"] = n_steps
    d = {"features": "use_coords, embedding", "F": fspec.feature_dim(4),
         "F_pad": pad_dim(fspec.feature_dim(4)), "seconds": sec_d, "peak_device_gb": peak_d,
         "launches_k2": n_steps, "identical_to_encode_image": True,
         "encode_image_seconds": [solo_s[("coords", K)] for K in Ks]}
    assert d["F_pad"] == 256

    # the pipelined decode of every stream, against decode_stream
    named = ([(f"a{s}_K{K}", scenes[s], K, streams_a[(s, K)]) for s in (42, 43) for K in Ks]
             + [(f"b_{p['image']}_K{p['K']}", img, cfg.K, r[0])
                for p, (img, cfg), r in zip(b_points, jobs_b, res_b)]
             + [(f"c{s}_K5", scenes[s], 5, r[0]) for s, r in zip((42, 43), res_c)]
             + [(f"d_K{K}", scenes[42], K, r[0]) for K, r in zip(Ks, res_d)])
    (piped, pipe_s, launches, pipe_peak) = counted_run(
        lambda: list(codec.decode_pipelined_iter(n[3] for n in named)))
    assert launches == [0, 0] and len(piped) == len(named)
    solo_dec, plain_dec, dec = [], [], []
    for (name, img, K, stream), (rec, st) in zip(named, piped):
        t0 = time.time()
        ref, ref_st = codec.decode_stream(stream)
        solo_dec.append(time.time() - t0)
        assert np.array_equal(rec, ref), name
        assert rec.shape == img.shape and np.array_equal(rec >> K, img >> K), name
        want = "coords" if name.startswith("d_") else "dispatch_pipelined"
        assert (want == "dispatch_pipelined") == ("dispatch_pipelined" in st.phases), (name, st)
        assert ref_st.phases.keys() == st.phases.keys(), name
        if want == "dispatch_pipelined":  # the streamed lpc path against the plain one
            with plain_decode_path():
                t0 = time.time()
                plain, plain_st = codec.decode_stream(stream)
                plain_dec.append(time.time() - t0)
            assert "base_decode" in plain_st.phases and np.array_equal(rec, plain), name
        dec.append({"stream": name, "phases": sorted(st.phases), "psnr_db": psnr(img, rec)})
    decode = {"streams": len(named), "pipelined_s": pipe_s,
              "pipelined_s_per_stream": pipe_s / len(named),
              "decode_stream_s_per_stream": sum(solo_dec) / len(named),
              "plain_path_streams": len(plain_dec),
              "plain_path_s_per_stream": sum(plain_dec) / len(plain_dec),
              "streamed_lpc_bit_identical_to_plain_path": True,
              "peak_device_gb": pipe_peak, "bit_identical_to_decode_stream": True,
              "msb_exact": True, "per_stream": dec}
    emit({"phase": "dataset", "synth_s": synth_s, "a_bench_cell": a, "b_bucket": b,
          "c_pipelined": c, "d_coords": d, "decode": decode,
          "solo_encode_s": {str(k): v for k, v in solo_s.items()},
          "total_seconds": time.time() - t_phase})
    return {"scenes": scenes, "streams": streams_a,
            "psnr": {(int(n[0][1:3]), n[2]): x["psnr_db"] for n, x in zip(named[:8], dec[:8])}}


def phase_sweep_cli(k1, k2, data):
    """`cli.sweep` on the dataset phase's two scenes written as TIFFs, in
    this process with the counts zeroed before each run: --batch-experts
    over both scenes at K 3..6 (one chunk of 8 experts; the streams are
    the dataset phase's (a)), the same command again (resumes, launches
    nothing), then --pipeline and the per-job path on scene 42 at K 5..6."""
    import glob
    import io
    import tempfile

    from lbdrn_msic_tpu_torch.cli import sweep as sweep_cli
    from lbdrn_msic_tpu_torch.core.config import TrainSpec
    from lbdrn_msic_tpu_torch.io.tiff import write_tiff
    from lbdrn_msic_tpu_torch.train.loop import _batch_geometry
    from lbdrn_msic_tpu_torch.utils.logging import scrape_log

    t_phase = time.time()
    train = TrainSpec(sample_granule=8, epochs=10)
    n_steps = train.epochs * _batch_geometry(train, 2048, 2048).steps
    tmp = tempfile.mkdtemp(prefix="sweep_cli_")
    paths = {}
    for s, img in data["scenes"].items():
        paths[s] = os.path.join(tmp, f"s{s}.tif")
        write_tiff(paths[s], img)
    flags = ["-g", "8", "--base-codec", "lpc"]

    def sweep(out, scenes, k_min, k_max, *mode):
        printed = io.StringIO()
        argv = ["-i", *[paths[s] for s in scenes], "-o", os.path.join(tmp, out), *flags,
                "--k-min", str(k_min), "--k-max", str(k_max), *mode]
        with contextlib.redirect_stdout(printed):
            rc, secs, launches, _ = counted_run(lambda: sweep_cli.main(argv))
        assert rc == 0, rc
        got = {}
        for s in scenes:
            for K in range(k_min, k_max + 1):
                run_dir, = glob.glob(os.path.join(tmp, out, f"s{s}_r1_K{K}_*"))
                with open(os.path.join(run_dir, f"s{s}.bin"), "rb") as f:
                    got[(s, K)] = (f.read(), scrape_log(os.path.join(run_dir, "decode.txt")))
        return got, secs, launches, printed.getvalue()

    experts, secs, launches, _ = sweep("experts", (42, 43), 3, 6, "--batch-experts")
    assert launches == [0, n_steps], launches
    k2["launches_by_path"]["sweep_cli"] = launches[1]
    for key, (stream, log) in experts.items():
        assert stream == data["streams"][key], ("batch-experts", key)
        assert log["psnr"] == data["psnr"][key], (key, log, data["psnr"][key])
    _, again_s, again, printed = sweep("experts", (42, 43), 3, 6, "--batch-experts")
    assert again == [0, 0] and "encode of" not in printed and "decoded" not in printed, printed
    modes = {}
    for name, mode in (("pipeline", ["--pipeline"]), ("per_job", [])):
        got, m_s, launches, _ = sweep(name, (42,), 5, 6, *mode)
        assert launches == [2 * n_steps, 0], (name, launches)
        assert {k: v[0] for k, v in got.items()} == \
            {k: data["streams"][k] for k in got}, name
        k1["launches_by_path"][f"sweep_cli_{name}"] = launches[0]
        modes[name] = {"seconds": m_s, "launches_k1": launches[0],
                       "identical_to_batch_experts": True}
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "sweep_cli", "flags": flags + ["--batch-experts", "--k-min", "3",
                                                   "--k-max", "6"],
          "batch_experts": {"seconds": secs, "launches_k2": n_steps,
                            "identical_to_dataset_a": True, "psnr_equal_to_dataset_decode": True},
          "resume": {"seconds": again_s, "launches": again}, "scene42_K5_6": modes,
          "total_seconds": time.time() - t_phase})


def tile_stagings(img, cfg):
    """The staging mode `encode_image` picks for each tile of img."""
    from lbdrn_msic_tpu_torch.codec import pick_staging
    from lbdrn_msic_tpu_torch.io.tiles import tile_bounds

    return [pick_staging(h, w, img.shape[0], int(img[:, y:y + h, x:x + w].max()) >> cfg.K,
                         cfg.features, cfg.train, warn=False)[0]
            for y, x, h, w in tile_bounds(*img.shape[1:], cfg.split_ratio)]


def encode_launches(img, cfg) -> int:
    """K1 launches of one `encode_image`: epochs x steps, summed over the
    tiles."""
    from lbdrn_msic_tpu_torch.io.tiles import tile_bounds
    from lbdrn_msic_tpu_torch.train.loop import _batch_geometry

    return sum(cfg.train.epochs * _batch_geometry(cfg.train, h, w, st).steps
               for (_, _, h, w), st in zip(tile_bounds(*img.shape[1:], cfg.split_ratio),
                                           tile_stagings(img, cfg)))


def phase_tiles(k1, gf2=None):
    """Multi-tile encodes (split_ratio 2), each run with the counts zeroed
    before it: (a) the bench scene, four 1024^2 "cached" tiles, encoded
    with the double-buffering gate open (tiles 2-4 uploaded aside while
    their predecessor trains) and forced shut, in the order open, shut,
    shut, open: the streams byte-identical, 5120 K1 launches each, the
    decode MSB-exact; (b) GF-2 (7605x7815x4, seed 42,
    e=GF2_EPOCHS), four "cached" tiles at the card's budget (each
    ~3803x3908 tile's f32 feature cache, 14.2 GiB by the budget's count),
    where a tile's upload and prep is largest, with the gate open and shut
    in the same order: the streams byte-identical, epochs x steps summed
    over the tiles K1 launches each, MSB-exact, seconds and peak device
    memory, allocated and reserved (held to PEAK_LIMIT_GB), beside the
    split_ratio 1 "full" K=5 encode (`gf2`: the staging phase's image and
    row, at the same epochs; else both made here)."""
    import numpy as np

    from lbdrn_msic_tpu_torch import codec
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.eval.metrics import psnr
    from lbdrn_msic_tpu_torch.io.tiles import tile_bounds
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene

    t_phase = time.time()
    train = TrainSpec(sample_granule=8, epochs=10)
    sha = lambda b: hashlib.sha256(b).hexdigest()

    def encode(img, cfg, gate_open, run=counted_run):
        aside = []
        with recording(codec, "_upload_tile_aside", aside):
            if gate_open:
                out = run(lambda: codec.encode_image(img, cfg))
            else:
                with replaced(codec, "OVERLAP_BUDGET_BYTES", 0):
                    out = run(lambda: codec.encode_image(img, cfg))
        assert len(aside) == (3 if gate_open else 0), (gate_open, len(aside))
        return out

    # (a) the bench scene at split_ratio 2
    img = synth_scene(2048, 2048, channels=4, effective_bits=12, seed=42)
    cfg = CodecConfig(K=5, split_ratio=2, base_codec="lpc", train=train)
    assert codec.tiles_overlap(img.shape, int(img.max()), 2, cfg)
    n_a = encode_launches(img, cfg)
    assert n_a == 5120 and tile_stagings(img, cfg) == ["cached"] * 4, (n_a,
                                                                       tile_stagings(img, cfg))
    warm = codec.encode_image(img, cfg)[0]
    runs = {True: [], False: []}
    for gate_open in (True, False, False, True):
        (stream, stats), secs, launches, peak = encode(img, cfg, gate_open)
        assert launches == [n_a, 0], (gate_open, launches)
        assert stream == warm, f"gate {'open' if gate_open else 'shut'} gave another stream"
        assert sum(t.train_time for t in stats.tiles) <= stats.elapsed
        runs[gate_open].append({"seconds": secs, "peak_device_gb": peak, "phases": stats.phases,
                                "tile_train_s": [t.train_time for t in stats.tiles]})
    rec, _ = codec.decode_stream(warm)
    assert rec.shape == img.shape and np.array_equal(rec >> 5, img >> 5)
    k1["launches_by_path"]["tiles_bench_sr2"] = n_a
    a = {"shape": list(img.shape), "split_ratio": 2, "staging": tile_stagings(img, cfg),
         "launches_k1": n_a, "order": "open, shut, shut, open",
         "overlapped": runs[True], "serial": runs[False],
         "overlapped_s": [r["seconds"] for r in runs[True]],
         "serial_s": [r["seconds"] for r in runs[False]],
         "identical": True, "psnr_db": psnr(img, rec), "bpsp": stats.bpsp, "sha256": sha(warm)}

    # (b) GF-2 at split_ratio 2, the gate open and shut in turn
    t0 = time.time()
    train_b = TrainSpec(sample_granule=8, epochs=GF2_EPOCHS)
    if gf2 is None:
        big = synth_scene(7605, 7815, channels=4, effective_bits=12, seed=42, fast=True)
        cfg1 = CodecConfig(K=5, base_codec="lpc", train=train_b)
        (_, st1), secs1, _, peak1, res1 = gaofen_run(lambda: codec.encode_image(big, cfg1))
        sr1 = {"seconds": secs1, "peak_device_gb": peak1, "peak_reserved_gb": res1,
               "staging": st1.tiles[0].staging,
               "epochs": train_b.epochs, "source": "encoded in this phase"}
    else:
        big = gf2["big"]
        sr1 = {"seconds": gf2["k5_full"]["seconds"],
               "peak_device_gb": gf2["k5_full"]["peak_device_gb"],
               "peak_reserved_gb": gf2["k5_full"]["peak_reserved_gb"],
               "staging": gf2["k5_full"]["staging"], "epochs": GF2_EPOCHS,
               "source": "the staging phase's (b)"}
    cfg = CodecConfig(K=5, split_ratio=2, base_codec="lpc", train=train_b)
    assert codec.tiles_overlap(big.shape, int(big.max()), 2, cfg)
    n_b = encode_launches(big, cfg)
    runs_b, first = {True: [], False: []}, None
    for gate_open in (True, False, False, True):
        (stream, stats), secs, launches, peak, reserved = encode(big, cfg, gate_open,
                                                                 gaofen_run)
        assert launches == [n_b, 0], (gate_open, launches, n_b)
        assert [t.staging for t in stats.tiles] == tile_stagings(big, cfg) == ["cached"] * 4, \
            stats.tiles
        first = stream if first is None else first
        assert stream == first, f"gate {'open' if gate_open else 'shut'} gave another stream"
        runs_b[gate_open].append({"seconds": secs, "peak_device_gb": peak,
                                  "peak_reserved_gb": reserved,
                                  "phases": stats.phases,
                                  "tile_train_s": [t.train_time for t in stats.tiles]})
    (rec, _), dec_s, dl, dec_peak = counted_run(lambda: codec.decode_stream(first))
    assert dl == [0, 0] and rec.shape == big.shape and np.array_equal(rec >> 5, big >> 5)
    k1["launches_by_path"]["tiles_gf2_sr2"] = n_b
    b = {"shape": list(big.shape), "split_ratio": 2, "epochs": train_b.epochs,
         "tiles": [list(t[2:]) for t in tile_bounds(*big.shape[1:], 2)],
         "staging": [t.staging for t in stats.tiles],
         "staged_bytes": [t.staged_bytes for t in stats.tiles],
         "launches_k1": n_b, "order": "open, shut, shut, open",
         "overlapped": runs_b[True], "serial": runs_b[False],
         "overlapped_s": [r["seconds"] for r in runs_b[True]],
         "serial_s": [r["seconds"] for r in runs_b[False]], "identical": True,
         "psnr_db": psnr(big, rec), "bpsp": stats.bpsp, "decode_s": dec_s,
         "decode_peak_device_gb": dec_peak, "sha256": sha(first), "split_ratio_1_k5": sr1,
         "seconds_incl_setup": time.time() - t0}
    emit({"phase": "tiles", "gate_budget_bytes": codec.OVERLAP_BUDGET_BYTES,
          "a_bench_sr2": a, "b_gf2_sr2": b, "total_seconds": time.time() - t_phase})


# the flagship phase's scenes (one of each group at its real shape), rate
# points (the cubic BD fit needs four) and epochs (one, to keep the script
# inside its time with the bench phase)
FLAGSHIP_SCENES = ("GF2_D", "WFI_A", "PMS_A")
FLAGSHIP_KS = (3, 4, 5, 6)
FLAGSHIP_EPOCHS = 1
# the experts of each chunk `encode_dataset` trains a scene in at K 3..6:
# its bucket's "full" tap matrices (GiB at K 3, 4, 5, 6: GF-2 11.72,
# 11.72, 5.86, 5.86; WFI 14.06, 14.06, 7.03, 7.03; PMS 7.03, 7.03, 3.52,
# 3.52) and its image and label store (0.94, 1.13, 0.56) packed within
# the card's staging budget
FLAGSHIP_CHUNKS = {"GF2_D": [4], "WFI_A": [3, 1], "PMS_A": [4]}


def phase_flagship(k1, k2, gf2=None):
    """The flagship workload's composition on one scene of each group at
    its real shape (`scripts.flagship_workload.run`: bucketed dataset
    encode, pipelined decode, summarize, Baseline, BD table), with the
    counts zeroed before it: every stream MSB-lossless; each scene's
    chunks FLAGSHIP_CHUNKS and its encode's peaks, allocated and reserved,
    within PEAK_LIMIT_GB; K2 launched epochs x steps per chunk, summed over
    the chunks (K1 never); each
    scene's K=5 stream byte-identical to `encode_image(bucket=True)`'s
    (else within 0.1 dB); those three streams' pipelined decode bit for
    bit `decode_stream`; in every group BD-PSNR > 0 and BD-Rate < 0
    against Baseline.  Works in a temporary directory (about 1.1 GB of
    TIFFs), removed after.  With `gf2` (the staging phase's result) GF2_D
    is the staging phase's GF-2 scene (its shape; seed 42), written as
    GF2_D's TIFF before the run, which then reads it instead of making
    the scene a second time."""
    import tempfile

    import numpy as np

    from lbdrn_msic_tpu_torch import codec
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.eval.metrics import psnr
    from lbdrn_msic_tpu_torch.scripts import flagship_workload as fw
    from lbdrn_msic_tpu_torch.train.loop import _batch_geometry

    t_phase = time.time()
    scenes = [row for row in fw.SCENES if row[0] in FLAGSHIP_SCENES]
    ks = list(FLAGSHIP_KS)
    train = TrainSpec(sample_granule=8, epochs=FLAGSHIP_EPOCHS)
    tmp = tempfile.mkdtemp(prefix="flagship_")
    try:
        gf2_d = "synth_scene(seed=scene_seed('GF2_D'))"
        if gf2 is not None:
            from lbdrn_msic_tpu_torch.io.tiff import write_tiff

            os.makedirs(os.path.join(tmp, "data"))
            write_tiff(os.path.join(tmp, "data", "GF2_D.tif"), gf2["big"])
            gf2_d = "the staging phase's GF-2 scene (seed 42)"
        with recording(codec, "fit_rate_experts", []) as calls:
            r, secs, launches, peak = counted_run(
                lambda: fw.run(scenes, ks, FLAGSHIP_EPOCHS, tmp))
        assert r["n_lossless"] == r["n_jobs"] == len(scenes) * len(ks), r["n_lossless"]
        # K2: one launch a step per chunk, epochs x steps at the chunk's
        # bucket shape and staging, by the plan each scene's encode ran
        want = 0
        plans = r["plans"]
        assert set(plans) == set(FLAGSHIP_SCENES), plans
        chunk_experts = {stem: [len(c) for c in p["chunks"]] for stem, p in plans.items()}
        assert chunk_experts == FLAGSHIP_CHUNKS, chunk_experts
        for stem, plan in plans.items():
            assert plan["budget"] == codec.STAGE_BUDGET_BYTES, (stem, plan["budget"])
            plan.update(peak_device_gb=r["scene_peaks"][stem]["allocated_gb"],
                        peak_reserved_gb=r["scene_peaks"][stem]["reserved_gb"])
            assert max(plan["peak_device_gb"], plan["peak_reserved_gb"]) <= PEAK_LIMIT_GB, \
                (stem, plan)
        for stem, plan in plans.items():
            steps = _batch_geometry(train, *plan["bucket"], plan["staging"]).steps
            want += len(plan["chunks"]) * train.epochs * steps
            plan["steps_per_epoch"] = steps
        assert launches == [0, want], (launches, want)
        assert len(calls) == sum(len(p["chunks"]) for p in plans.values()), len(calls)
        k2["launches_by_path"]["flagship"] = want
        for name in r["groups"]:
            assert r["bd_psnr"][name] > 0 and r["bd_rate"][name] < 0, (name, r["bd_rate"],
                                                                      r["bd_psnr"])

        # each scene's K=5 stream against encode_image(bucket=True)
        bins = {(stem, K): path for path, stem, K in r["bins"]}
        cfg5 = CodecConfig(K=5, base_codec="lpc", train=train)
        k5, k5_streams, n_k1 = [], [], 0
        for stem, C, H, W in scenes:
            img = r["imgs"][stem]
            with open(bins[(stem, 5)], "rb") as f:
                got = f.read()
            (ref, st), ref_s, ref_launches, ref_peak, ref_reserved = gaofen_run(
                lambda: codec.encode_image(img, cfg5, bucket=True))
            Hb, Wb = codec.bucket_dims(H, W, cfg5.features.D)
            want_k1 = train.epochs * _batch_geometry(train, Hb, Wb, st.tiles[0].staging).steps
            assert ref_launches == [want_k1, 0], (stem, ref_launches, want_k1)
            n_k1 += ref_launches[0]
            same = got == ref
            d_db = 0.0
            if not same:  # "banded" and "full" batches: RD-equivalent only
                d_db = (psnr(img, codec.decode_stream(got)[0])
                        - psnr(img, codec.decode_stream(ref)[0]))
                assert abs(d_db) < 0.1, (stem, d_db)
            k5.append({"scene": stem, "identical_to_encode_image_bucket": same,
                       "psnr_minus_encode_image_db": d_db,
                       "encode_image_staging": st.tiles[0].staging,
                       "dataset_staging": plans[stem]["staging"],
                       "encode_image_s": ref_s, "encode_image_peak_device_gb": ref_peak,
                       "encode_image_peak_reserved_gb": ref_reserved,
                       "encode_image_launches_k1": ref_launches[0]})
            k5_streams.append(got)
        k1["launches_by_path"]["flagship_encode_image_k5"] = n_k1
        (piped, pipe_s, pl, _) = counted_run(
            lambda: list(codec.decode_pipelined_iter(iter(k5_streams))))
        assert pl == [0, 0]
        for (stem, _, _, _), stream, (rec, _) in zip(scenes, k5_streams, piped):
            assert np.array_equal(rec, codec.decode_stream(stream)[0]), stem
        with open(r["raw"]) as f:
            raw_lines = f.read().splitlines()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "flagship", "scenes": [list(s) for s in scenes], "gf2_d_image": gf2_d,
          "Ks": ks,
          "epochs": FLAGSHIP_EPOCHS, "seconds": secs, "peak_device_gb": peak,
          "launches_k1": launches[0], "launches_k2": launches[1],
          "chunk_experts": chunk_experts,
          "plans": plans, "groups": r["groups"],
          "msb_lossless": f"{r['n_lossless']}/{r['n_jobs']}",
          "encode_s": r["encode_s"], "encode_mpx_s": r["encode_mpx_s"],
          "decode_s": r["decode_s"], "decode_mpx_s": r["decode_mpx_s"],
          "peak_encode_gb": r["peak_encode_gb"], "peak_decode_gb": r["peak_decode_gb"],
          "bd_rate_pct": r["bd_rate"], "bd_psnr_db": r["bd_psnr"], "table": r["table"],
          "k5_vs_encode_image": k5, "k5_pipelined_decode_bit_identical": True,
          "k5_pipelined_decode_s": pipe_s,
          "log": [ln for ln in raw_lines if ln.startswith("[")],
          "total_seconds": time.time() - t_phase})


def sweep_launches(images, cfg, ks):
    """[K1, K2] launches of `scripts.ablations.sweep_variant_csv`: for each
    scene, one expert fit a plan group (epochs x steps at the plan's
    staging) where the configs train as experts, else one `encode_image`
    a K."""
    import dataclasses

    from lbdrn_msic_tpu_torch import codec
    from lbdrn_msic_tpu_torch.train.loop import _batch_geometry

    cfgs = [dataclasses.replace(cfg, K=K) for K in ks]
    k1 = k2 = 0
    for img in images.values():
        staging, _, groups, _ = codec.plan_rate_points(img, cfgs)
        if codec._experts_compatible(cfgs) and staging != "gather":
            k2 += len(groups) * cfg.train.epochs * _batch_geometry(cfg.train, *img.shape[1:],
                                                                   staging).steps
        else:
            k1 += sum(encode_launches(img, c) for c in cfgs)
    return [k1, k2]


# the validation studies' suites (size, scenes): the scripts' defaults, and
# the ablations' network group at the bench scene (repro_all's ablations2048)
VALIDATION_SUITES = {"rd": (512, 3), "ablations": (256, 2), "network": (2048, 1)}
# that network group's epochs (its variants' default is 10): each width's
# K2 fits at the bench scene's staging, a fifth of the steps
NETWORK_2048_EPOCHS = 2


def phase_validation(k1, k2, multik):
    """The reference's validation studies through the port's scripts, each
    run with the counts zeroed before it (`counted_run`): rd_validation,
    substitute_anchors, recipe_study and the ablation matrix at their
    defaults, then the ablations' network group at the bench scene
    (2048^2, one scene, repro_all's ablations2048).  Launch counts exact,
    every stream MSB-exact, BD against each study's anchor; the network
    group at 2048^2 trains NETWORK_2048_EPOCHS.  The JPEG 2000
    anchors and the half-step BDR slot are OpenCV's: without it they are
    left out (listed) and the LBDRN streams take the lpc base.  multik:
    the multi_k phase's `profiling.multik_ab` rows."""
    import dataclasses
    import tempfile

    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.eval.reports import bd_report
    from lbdrn_msic_tpu_torch.scripts import ablations, rd_validation, recipe_study
    from lbdrn_msic_tpu_torch.scripts import substitute_anchors as sa
    from lbdrn_msic_tpu_torch.scripts.suite import synth_suite

    t_phase = time.time()
    try:
        import cv2  # noqa: F401

        opencv = True
    except ImportError:
        opencv = False
    base = "jp2" if opencv else "lpc"
    left_out = []
    ks = list(range(1, 7))
    bd = lambda r: {"bd_rate_pct": r.group_rate["all"], "bd_psnr_db": r.group_psnr["all"]}
    tmp = tempfile.mkdtemp(prefix="validation_")
    try:
        # rd_validation at its defaults: 512^2, 3 scenes, K 1..6, e=10: 18
        # jobs of 10 x 32 K1 steps
        size, n_scenes = VALIDATION_SUITES["rd"]
        imgs_rd = synth_suite(size, n_scenes)
        n_jobs = len(ks) * n_scenes

        def pipelined_launches(epochs):
            return [sum(encode_launches(img, CodecConfig(K=K, train=TrainSpec(
                epochs=epochs, sample_granule=8))) for K in ks for img in imgs_rd.values()), 0]

        sweep, secs, launches, _ = counted_run(lambda: rd_validation.lbdrn_sweep(
            imgs_rd, ks, 10, 8, os.path.join(tmp, "lbdrn_results.csv"), None, base))
        assert launches == pipelined_launches(10), launches
        assert sweep["msb_exact"] == sweep["jobs"] == n_jobs, sweep["msb_exact"]
        rd = {"size": size, "scenes": n_scenes, "Ks": ks, "epochs": 10, "base_codec": base,
              "seconds": secs, "launches_k1": launches[0],
              "msb_exact": f"{n_jobs}/{n_jobs}",
              "psnr_db_bpsp": {f"K{K}": [sweep["rd"][(K, "scene0")][i] for i in (1, 2)]
                               for K in ks}}
        if opencv:
            t0 = time.time()
            anchor_csvs = rd_validation.anchor_sweep(imgs_rd, 1, 6, tmp)
            lines, res = rd_validation.bd_lines(anchor_csvs, sweep["csv"], n_scenes, len(ks))
            base_bd = res["Baseline"]
            assert base_bd.group_rate["all"] < 0 < base_bd.group_psnr["all"], lines
            rd.update(anchors_s=time.time() - t0, bd_lines=lines,
                      bd={m: bd(r) for m, r in res.items()})
        else:
            left_out += ["rd_validation: the Baseline, JPEG2000star and JPEG2000 anchors "
                         "and their BD lines"]
        k1["launches_by_path"]["rd_validation"] = launches[0]

        # substitute_anchors at its defaults: 256^2, 2 scenes (host codecs)
        imgs_abl = synth_suite(*VALIDATION_SUITES["ablations"])
        t0 = time.time()
        subs = {"dlpr": sa.dlpr_substitute(imgs_abl, [0, 1, 2, 5, 10, 20], tmp),
                "jxl": sa.jxl_substitute(imgs_abl, tmp)}
        if opencv:
            subs["bdr"] = sa.bdr_halfstep(imgs_abl, range(8, 13), tmp)
        else:
            left_out.append("substitute_anchors: the half-step BDR slot (PNG divs)")
        with open(subs["dlpr"]) as f:
            tau0 = f.read().splitlines()[1].split(",")
        # tau=0 is lossless: every scene's PSNR infinite
        assert tau0[0] == "tau0" and set(tau0[2::4]) == {"inf"}, tau0
        substitute = {"seconds": time.time() - t0,
                      "csvs": sorted(os.path.basename(p) for p in subs.values()),
                      "dlpr_tau0_lossless": True}

        # recipe_study at its defaults: the four recipes over imgs_rd
        runs, recipe = {}, {"base_codec": base, "recipes": []}
        for tag, schedule, epochs in recipe_study.RECIPES:
            r, secs, launches, _ = counted_run(lambda: recipe_study.run_recipe(
                imgs_rd, ks, tag, schedule, epochs, 8, tmp, None, base))
            assert launches == pipelined_launches(epochs), (tag, launches)
            assert r["msb_exact"] == n_jobs, (tag, r["msb_exact"])
            runs[tag] = r
            recipe["recipes"].append({"tag": tag, "schedule": schedule, "epochs": epochs,
                                      "seconds": secs, "s_per_job": r["s_per_job"],
                                      "launches_k1": launches[0]})
            k1["launches_by_path"][f"recipe_{tag}"] = launches[0]
        table, res = recipe_study.recipe_table(runs, n_scenes, len(ks), f"({size}^2 suite)")
        for row in recipe["recipes"]:
            row.update(bd(res[row["tag"]]) if row["tag"] in res else {})
        recipe["table"] = table[5:]

        # the ablation matrix: every variant's sweep counted and checked,
        # at the variant's epochs or at epochs[0] where that is set
        variants, epochs = [], [None]

        def counted_sweep(images, cfg, ks_, granule, path, device=None):
            if epochs[0] is not None:
                cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                         epochs=epochs[0]))
            (out, n_exact), secs, launches, peak = counted_run(
                lambda: real_sweep(images, cfg, ks_, granule, path, device))
            want = sweep_launches(images, cfg, ks_)
            assert launches == want, (path, launches, want)
            assert n_exact == len(images) * len(ks_), (path, n_exact)
            variants.append({"csv": path, "seconds": secs, "launches_k1": launches[0],
                             "launches_k2": launches[1], "peak_device_gb": peak,
                             "msb_exact": f"{n_exact}/{n_exact}"})
            return out, n_exact

        def matrix(images, groups, out):
            rows = {}
            for group in groups:
                anchor, _ = ablations.variant_matrix()[group]
                t0 = time.time()
                md, csvs = ablations.run_group(images, group, ks, 8, out, None,
                                               base_codec=base)
                done = {v["csv"]: v for v in variants}
                rows[group] = {"anchor": anchor, "seconds": time.time() - t0,
                               "table": md[1].splitlines(), "variants": {}}
                for name, path in csvs.items():
                    v = dict(done[path])
                    del v["csv"]
                    if name != anchor:
                        v.update(bd(bd_report(csvs[anchor], path, len(images), len(ks))))
                    rows[group]["variants"][name] = v
            return rows

        real_sweep = ablations.sweep_variant_csv
        with replaced(ablations, "sweep_variant_csv", counted_sweep):
            abl = matrix(imgs_abl, ablations.GROUPS, os.path.join(tmp, "ablations"))
            imgs_net = synth_suite(*VALIDATION_SUITES["network"])
            epochs[0] = NETWORK_2048_EPOCHS
            net = matrix(imgs_net, ["network"], os.path.join(tmp, "ablations_2048"))
        for group, rows in (*abl.items(), ("network_2048", net["network"])):
            for kern, key in ((k1, "launches_k1"), (k2, "launches_k2")):
                n = sum(v[key] for v in rows["variants"].values())
                if n:
                    kern["launches_by_path"][f"ablations_{group}"] = n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "validation", "opencv": opencv, "base_codec": base, "left_out": left_out,
          "rd_validation": rd, "substitute_anchors": substitute, "recipe_study": recipe,
          "ablations_256": {"size_scenes": VALIDATION_SUITES["ablations"], "Ks": ks,
                            "groups": abl},
          "network_2048": {"size_scenes": VALIDATION_SUITES["network"], "Ks": ks,
                           "epochs": NETWORK_2048_EPOCHS, **net["network"]},
          "multik_ab": [{k: row[k] for k in ("multi_k", "seconds", "launches", "kernel",
                                              "identical_to_multi_k_0")} for row in multik],
          "total_seconds": time.time() - t_phase})

# the mesh phase's world: 2 processes sharing cuda:0 over gloo (the card's
# machine has one card), their group timeout and the parent's join limit
MESH_WORLD = 2
MESH_GROUP_TIMEOUT_S = 300
MESH_JOIN_S = 600
# the dp = 2 encode's epochs (the exact step, ~4 s an epoch on both ranks):
# two show the ranks' agreement and the fit's as ten do
MESH_DP_EPOCHS = 2


def bench_mesh_inputs():
    """The bench scene and the mesh phase's configs: the sweep's K 3..6
    (lpc base, g=8, e=10) and the dp encode's K=5 at MESH_DP_EPOCHS."""
    import dataclasses

    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene

    img = synth_scene(2048, 2048, channels=4, effective_bits=12, seed=42)
    train = TrainSpec(sample_granule=8, epochs=10)
    cfgs = [CodecConfig(K=K, base_codec="lpc", train=train) for K in (3, 4, 5, 6)]
    return img, cfgs, dataclasses.replace(
        cfgs[2], train=dataclasses.replace(train, epochs=MESH_DP_EPOCHS))


def mesh_rank(rank: int, world: int, work: str) -> None:
    """One rank of the mesh phase's gloo world on cuda:0: the ep = 2 rate
    sweep, the dp = 2 encode and the sp = 2 decode of the stream in `work`,
    each with the launch counts zeroed just before it and read just after;
    results pickled to work/rank{rank}.pkl."""
    import datetime
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    from lbdrn_msic_tpu_torch.codec import decode_stream, encode_image, encode_rate_points
    from lbdrn_msic_tpu_torch.ops.fused_step import fused_expert_step, fused_train_step
    from lbdrn_msic_tpu_torch.parallel.distributed import initialize_cluster
    from lbdrn_msic_tpu_torch.parallel.shard import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_cluster(init_method="file://" + os.path.join(work, "store"), num_processes=world,
                       process_id=rank, backend="gloo", device="cuda:0",
                       timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S))
    img = np.load(os.path.join(work, "img.npy"))
    with open(os.path.join(work, "stream.bin"), "rb") as f:
        stream = f.read()
    _, cfgs, dp_cfg = bench_mesh_inputs()
    timeout = datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S)
    ep, dp = make_mesh(ep=world, timeout=timeout), make_mesh(dp=world, timeout=timeout)
    out = {"rank": rank, "backend": dist.get_backend()}

    def run(name, fn):
        fused_train_step.launches = fused_expert_step.launches = 0
        dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        got = fn()
        torch.cuda.synchronize()
        out[name] = {"seconds": time.time() - t0, "launches_k1": fused_train_step.launches,
                     "launches_k2": fused_expert_step.launches,
                     "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
        return got

    out["ep"]["streams"] = [s for s, _ in run("ep", lambda: encode_rate_points(img, cfgs,
                                                                                mesh=ep))]
    out["dp"]["stream"] = run("dp", lambda: encode_image(img, dp_cfg, mesh=dp))[0]
    rec = run("sp", lambda: decode_stream(stream, mesh=dp))[0]
    out["sp"]["sha256"] = hashlib.sha256(rec.tobytes()).hexdigest()
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def phase_mesh(card: str, k2, sweep_streams=None, encoded=None):
    """Multi-card parallelism on the one card: a world of MESH_WORLD
    processes over gloo on cuda:0 runs the ep = 2 sweep (every stream the
    sweep phase's, K2 at E = 2, epochs x steps launches per rank), the
    dp = 2 encode at MESH_DP_EPOCHS (MSB-exact, within 0.1 dB of a
    single-card fused encode at those epochs, made here) and the sp = 2
    decode of the bench stream (bit for bit the single-card decode); then
    a world of 1 over NCCL runs the collective helper on CUDA tensors.  The
    sweep and bench-stream references come from the sweep and encode
    phases, or are made here (`--only mesh`)."""
    import datetime
    import pickle
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from lbdrn_msic_tpu_torch.codec import decode_stream, encode_image, encode_rate_points
    from lbdrn_msic_tpu_torch.eval.metrics import psnr
    from lbdrn_msic_tpu_torch.parallel.distributed import (
        collect, collect_objects, initialize_cluster)
    from lbdrn_msic_tpu_torch.parallel.shard import make_mesh

    t_phase = time.time()
    img, cfgs, dp_cfg = bench_mesh_inputs()
    train = cfgs[0].train
    n_steps = train.epochs * -(-(-(-2048 * 2048 // 8)) // (train.batch_size // 8))
    if sweep_streams is None:
        sweep_streams = [s for s, _ in encode_rate_points(img, cfgs)]
    if encoded is None:
        encoded = {"stream": encode_image(img, cfgs[2])[0]}
    dp_ref = encode_image(img, dp_cfg)[0]
    p_ref = psnr(img, decode_stream(dp_ref)[0])
    ref_sha = hashlib.sha256(decode_stream(encoded["stream"])[0].tobytes()).hexdigest()

    with tempfile.TemporaryDirectory() as work:
        np.save(os.path.join(work, "img.npy"), img)
        with open(os.path.join(work, "stream.bin"), "wb") as f:
            f.write(encoded["stream"])
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                                   str(r), "--mesh-world", str(MESH_WORLD), "--mesh-work", work],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(MESH_WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=MESH_JOIN_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        world_s = time.time() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"mesh rank {r} exited {p.returncode}:\n{log[-4000:]}"
        ranks = []
        for r in range(MESH_WORLD):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))

    dp_stream = ranks[0]["dp"]["stream"]
    rec = decode_stream(dp_stream)[0]
    p_dp = psnr(img, rec)
    for r in ranks:
        assert r["ep"]["streams"] == sweep_streams, "ep sweep differs from the single-card sweep"
        assert r["ep"]["launches_k2"] == n_steps and r["ep"]["launches_k1"] == 0, r["ep"]
        assert r["dp"]["stream"] == dp_stream, "the dp ranks returned different streams"
        assert r["sp"]["sha256"] == ref_sha, "sp decode differs from the single-card decode"
    assert np.array_equal(rec >> dp_cfg.K, img >> dp_cfg.K), "dp encode: MSB path corrupted"
    assert abs(p_dp - p_ref) < 0.1, (p_dp, p_ref)
    k2["launches_by_path"]["mesh_ep_per_rank"] = ranks[0]["ep"]["launches_k2"]

    # a world of 1 over NCCL: the collective helper on CUDA tensors, over
    # the default group and over a one-rank mesh's "dp" group
    t0 = time.time()
    with tempfile.TemporaryDirectory() as work:
        dev = initialize_cluster(init_method="file://" + os.path.join(work, "store"),
                                 num_processes=1, process_id=0, device="cuda:0",
                                 timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S))
        try:
            backend = dist.get_backend()
            t = torch.arange(4, dtype=torch.float32, device=dev)
            one = make_mesh(dp=1, timeout=datetime.timedelta(seconds=MESH_GROUP_TIMEOUT_S))
            s, g = collect(t, None), collect(t, one.get_group("dp"), "gather")
            torch.cuda.synchronize()
            assert s.is_cuda and g.is_cuda and torch.equal(s, t) and torch.equal(g[0], t)
            assert collect_objects({"rank": 0}, None) == [{"rank": 0}]
        finally:
            dist.destroy_process_group()
    nccl_s = time.time() - t0

    per_rank = [{"rank": r["rank"], "backend": r["backend"],
                 **{f"{k}_{f}": r[k][f] for k in ("ep", "dp", "sp")
                    for f in ("seconds", "launches_k1", "launches_k2", "peak_device_gb")}}
                for r in ranks]
    emit({"phase": "mesh", "world": MESH_WORLD, "device": "cuda:0", "ranks": per_rank,
          "ep": {"ep": MESH_WORLD, "Ks": [c.K for c in cfgs],
                 "experts_per_rank": -(-len(cfgs) // MESH_WORLD),
                 "launches_k2_per_rank": [r["ep"]["launches_k2"] for r in ranks],
                 "expected_launches_per_rank": n_steps,
                 "identical_to_sweep_phase": True,
                 "sha256": [hashlib.sha256(s).hexdigest() for s in sweep_streams]},
          "dp": {"dp": MESH_WORLD, "K": dp_cfg.K, "epochs": MESH_DP_EPOCHS, "psnr_db": p_dp,
                 "psnr_single_card_fused_db": p_ref, "bpsp": len(dp_stream) * 8
                 / img.size, "msb_exact": True, "identical_across_ranks": True,
                 "sha256": hashlib.sha256(dp_stream).hexdigest()},
          "sp": {"sp": MESH_WORLD, "bit_identical_to_single_card_decode": True,
                 "sha256": ref_sha},
          "world_seconds": world_s,
          "nccl_world_1": {"backend": backend, "completed": True, "seconds": nccl_s},
          "multi_card_nccl": "unverified", "total_seconds": time.time() - t_phase,
          "card": card})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("kernels", "cli", "dataset", "flagship", "validation",
                                       "mesh", "bench"),
                    default=None,
                    help="kernels: the kernel phases only; cli: the encode and decode "
                         "phases and the cli phase only; dataset: the dataset "
                         "and sweep_cli phases only; flagship: the staging, tiles and "
                         "flagship phases only; validation: the multi_k and validation phases "
                         "only; mesh: the mesh phase only; bench: the bench phase "
                         "only (none of the last six prints the kernels line)")
    # one rank of the mesh phase's world (the script starts them itself)
    ap.add_argument("--mesh-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-work", type=str, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one encode, one sweep, two fits, two GF-2 epochs "
                         "and one dataset encode with torch.profiler")
    args = ap.parse_args()
    t_script = _phase_mark[0] = time.time()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    if args.mesh_rank is not None:
        mesh_rank(args.mesh_rank, args.mesh_world, args.mesh_work)
        return
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

    if args.only == "cli":
        k1 = {"launches_by_path": {}}
        encoded = phase_codec(args.profile, k1)
        phase_cli(k1, encoded, encoded["img"])
        emit({"k1_launches_by_path": k1["launches_by_path"]})
        return
    if args.only == "dataset":
        k1, k2 = {"launches_by_path": {}}, {"launches_by_path": {}}
        phase_sweep_cli(k1, k2, phase_dataset(args.profile, k1, k2))
        emit({"k1_launches_by_path": k1["launches_by_path"],
              "k2_launches_by_path": k2["launches_by_path"],
              "script_seconds": time.time() - t_script})
        return
    if args.only in ("mesh", "bench"):
        k1, k2 = {"launches_by_path": {}}, {"launches_by_path": {}}
        if args.only == "mesh":
            phase_mesh(card, k2)
        else:
            phase_bench(k1, k2)
        emit({"k1_launches_by_path": k1["launches_by_path"],
              "k2_launches_by_path": k2["launches_by_path"],
              "script_seconds": time.time() - t_script})
        print(card_line(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return
    if args.only in ("flagship", "validation"):
        k1, k2 = {"launches_by_path": {}}, {"launches_by_path": {}}
        if args.only == "flagship":
            gf2 = phase_staging(args.profile, k1, k2)
            phase_tiles(k1, gf2)
            phase_flagship(k1, k2, gf2)
        else:
            phase_validation(k1, k2, phase_multi_k(card, args.profile, {}, {}))
        emit({"k1_launches_by_path": k1["launches_by_path"],
              "k2_launches_by_path": k2["launches_by_path"],
              "script_seconds": time.time() - t_script})
        return
    k1 = phase_kernels(card)
    k2 = phase_expert_kernels(card)
    k3, k4 = phase_multi_kernels(card)
    phase_mm_dtype(card, fits=args.only != "kernels")
    k5 = phase_kernel_prof(card)
    if args.only != "kernels":
        encoded = phase_codec(args.profile, k1)
        sweep_solos, sweep_streams = phase_sweep(args.profile, k2)
        phase_rd(encoded, phase_bench(k1, k2, encoded["psnr_db"]))
        multik = phase_multi_k(card, args.profile, k3, k4)
        gf2 = phase_staging(args.profile, k1, k2)
        phase_tiles(k1, gf2)
        phase_cli(k1, encoded, encoded["img"])
        phase_sweep_cli(k1, k2, phase_dataset(args.profile, k1, k2, sweep_solos))
        phase_flagship(k1, k2, gf2)
        del gf2
        phase_validation(k1, k2, multik)
        phase_mesh(card, k2, sweep_streams, encoded)
    emit({"phase": "total", "script_seconds": time.time() - t_script,
          "phase_seconds": PHASE_SECONDS})
    emit({"kernels": [k1, k2, k3, k4, *k5]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
