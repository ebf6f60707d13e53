"""Expert-batched training utilisation against expert count, on the card.

The counterpart of scripts/profiling/mfu_experts.py: times
`fit_rate_experts` end to end at E in {1, 4, 8, 16} on one 2048^2 x 4
scene ("full" tap staging; E identical K=5 experts, int8 taps, 16 x 420 MB
at E=16) and converts the step rate to model-FLOP utilisation.

    python -m lbdrn_msic_tpu_torch.profiling.mfu_experts [--size 2048] [--epochs 10]

FLOP accounting (per expert, per step, B=8192 samples), as the JAX script:
forward matmuls 2B * (128*64 + 64*64 + 64*4); a training step ~3x the
forward; every eval epoch adds a forward pass over the whole image.  The
figure is end to end (staging gathers, evals and Adam included), a lower
bound on the kernels' own utilisation.  Peaks are the card's own
(`profiling.PEAKS`, chosen by its name): f32 on the CUDA cores, which the
fused step (K2) multiplies on, and the dense TF32 and bf16 tensor-core
rates for reference.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from lbdrn_msic_tpu_torch import resolve_device
from lbdrn_msic_tpu_torch.profiling import peaks


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=2048)
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--granule", type=int, default=8)
    p.add_argument("--experts", type=int, nargs="+", default=[1, 4, 8, 16])
    args = p.parse_args(argv)
    dev = resolve_device(None)

    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.features.engine import tap_matrix_dtype
    from lbdrn_msic_tpu_torch.models.siren import pad_dim
    from lbdrn_msic_tpu_torch.train.loop import fit_rate_experts
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene
    from lbdrn_msic_tpu_torch.utils.transfer import put_image

    H = W = args.size
    C = args.channels
    cfg = CodecConfig(train=TrainSpec(epochs=args.epochs, sample_granule=args.granule))
    fspec, mspec, tspec = cfg.features, cfg.model, cfg.train
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=7)
    dev_img = put_image(img, dev)
    pk = peaks(torch.cuda.get_device_name(dev))

    padded_in = pad_dim(fspec.feature_dim(C))
    bc = mspec.base_channel
    layer_flops = 2 * (padded_in * bc + (mspec.num_layers - 1) * bc * bc + bc * C)
    n = H * W
    bs = min(tspec.batch_size, n)
    g = max(1, tspec.sample_granule)
    steps_per_epoch = -(-(-(-n // g)) // (bs // g))
    flops_per_expert = (3 * layer_flops * bs * steps_per_epoch * args.epochs
                        + layer_flops * n * args.epochs)  # eval every epoch

    print(f"scene {H}x{W}x{C}, bs={bs}, {steps_per_epoch} steps/epoch x {args.epochs} epochs, "
          f"{flops_per_expert / 1e12:.2f} TFLOP/expert; {torch.cuda.get_device_name(dev)}")
    print(f"{'E':>3} {'wall s':>8} {'steps/s':>9} {'Msamp/s':>9} {'TFLOP/s':>8} "
          f"{'MFU f32':>8} {'MFU tf32':>9} {'MFU bf16':>9}")
    for E in args.experts:
        Ks = (5,) * E
        dts = [tap_matrix_dtype(int(img.max()) >> k, fspec.relative) for k in Ks]

        def run():
            res = fit_rate_experts(dev_img, Ks, torch.Generator().manual_seed(0), fspec, mspec,
                                   tspec, H, W, C, tap_dtypes=dts, device=dev)
            torch.cuda.synchronize()
            return res

        run()  # warm
        best = float("inf")
        for _ in range(2):
            t0 = time.time()
            run()
            best = min(best, time.time() - t0)
        total_steps = steps_per_epoch * args.epochs
        rate = flops_per_expert * E / best
        print(f"{E:>3} {best:>8.2f} {total_steps / best:>9.1f} "
              f"{E * bs * total_steps / best / 1e6:>9.1f} {rate / 1e12:>8.2f} "
              f"{rate / pk['f32'] * 100:>7.1f}% {rate / pk['tf32'] * 100:>8.2f}% "
              f"{rate / pk['bf16'] * 100:>8.2f}%", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
