"""Shared CLI plumbing: reference-compatible flags -> CodecConfig.

The flags are the JAX package's, flag for flag, plus `--device` (default
`cuda`; `cpu` only when asked).  `--mesh dp=N[,ep=M]` runs one process per
card under torchrun, every process with the same flags:

    torchrun --nproc-per-node N -m lbdrn_msic_tpu_torch.cli.encode --mesh dp=N ...

Rank 0 alone writes the run directory, its logs and outputs.
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from lbdrn_msic_tpu_torch import resolve_device
from lbdrn_msic_tpu_torch.core.config import CodecConfig, FeatureSpec, ModelSpec, TrainSpec


def add_codec_args(p: argparse.ArgumentParser, encode: bool = True):
    """Flag set mirrors reference encode.py:168-196 plus the switches the
    reference keeps in constants.py (here first-class and header-carried)."""
    p.add_argument("--seed", type=int, default=19920517)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; the run stops "
                        "when CUDA is absent unless --device cpu is given)")
    p.add_argument("--compile-log", action="store_true",
                   help="print the library build log after the run "
                        "(utils/build_log): each CUDA kernel and native codec "
                        "library, its seconds, rebuilt or loaded from its stamp")
    p.add_argument(
        "--mesh", type=str, default=None, metavar="AXES",
        help="device mesh spec, e.g. 'dp=4', 'ep=8' or 'dp=2,ep=4' (dp x ep "
             "processes under torchrun, one a card): dp trains each tile "
             "data-parallel and decodes it in row bands, ep fans a sweep's "
             "experts out over the ranks",
    )
    if encode:
        p.add_argument("-rn", "--randomness", action="store_true",
                       help="allow nondeterministic training (reference -rn)")
        p.add_argument("-sr", "--split_ratio", type=int, default=1)
        p.add_argument("-K", "--K", type=int, default=5)
        p.add_argument("-bc", "--base_channel", type=int, default=64)
        p.add_argument("-nl", "--num_layers", type=int, default=2)
        p.add_argument("-D", "--D", type=int, default=2)
        p.add_argument("-prec", "--precision", type=int, default=16)
        p.add_argument("-lr", "--lr", type=float, default=1e-3)
        p.add_argument("-bs", "--batch_size", type=int, default=8192)
        p.add_argument("-e", "--epochs", type=int, default=10)
        p.add_argument("-vd", "--val_duration", type=int, default=1)
        # feature-set switches (reference constants.py:1-14, README.md:50-62)
        p.add_argument("--use-coords", action="store_true")
        p.add_argument("--embedding", action="store_true")
        p.add_argument("--no-colors", action="store_true")
        p.add_argument("--abs-colors", action="store_true",
                       help="disable center subtraction (RELATIVE=False)")
        p.add_argument("--sigma", type=float, default=1.4)
        p.add_argument("--n-freq", type=int, default=12)
        # smooth cosine LR decay instead of the reference's StepLR;
        # typically pairs with more epochs (-e)
        p.add_argument("--schedule", choices=["step", "cosine"],
                       default="step")
        p.add_argument("-g", "--sample-granule", type=int, default=1,
                       help="shuffle g-pixel runs instead of single pixels "
                            "(g=1 = reference semantics)")
        p.add_argument("--bucket", action="store_true",
                       help="shape-bucketed training: pad each tile to a "
                            "canonical bucket (codec.bucket_dims) with the "
                            "pad masked out of every batch and eval. "
                            "RD-equivalent, not byte-identical, to exact-"
                            "shape runs")
        # codec selection (new; carried in the v1 header)
        p.add_argument("--base-codec", choices=["jp2", "lpc"], default="jp2")
        p.add_argument("--weight-codec", choices=["fpz", "raw16"], default="fpz")
        p.add_argument("--header-version", type=int, choices=[0, 1], default=1)


_MESHES: dict = {}  # (dp, ep) -> the mesh, made once a process


def mesh_from_args(args):
    """Parse --mesh 'dp=N[,ep=M]' into the world's mesh (None when the flag
    is unset).  The world comes from torchrun's environment
    (`parallel.distributed.initialize_cluster`; the rank's card is
    cuda:LOCAL_RANK, gloo with --device cpu) unless the process already
    set one up; without either the run stops, naming torchrun: there is no
    fallback to one card.  dp * ep must be the world size."""
    spec = getattr(args, "mesh", None)
    if not spec:
        return None
    axes = {"dp": 1, "ep": 1}
    for part in spec.split(","):
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in axes or not val.strip().isdigit():
            raise SystemExit(f"bad --mesh axis {part!r} (want dp=N / ep=N)")
        axes[name] = int(val)
    from lbdrn_msic_tpu_torch.parallel.distributed import initialize_cluster
    from lbdrn_msic_tpu_torch.parallel.shard import make_mesh

    if not dist.is_initialized():
        initialize_cluster(device=None if args.device == "cuda" else args.device)
    if not dist.is_initialized():
        n = axes["dp"] * axes["ep"]
        raise SystemExit(
            f"--mesh {spec!r} needs one process per card, started by torchrun: "
            f"torchrun --nproc-per-node {n} -m <this command> --mesh {spec} ... "
            f"(no torch.distributed world is set up in this process)")
    key = (axes["dp"], axes["ep"])
    if key not in _MESHES:
        try:
            _MESHES[key] = make_mesh(dp=axes["dp"], ep=axes["ep"])
        except ValueError as exc:
            raise SystemExit(f"--mesh {spec!r}: {exc}") from exc
    return _MESHES[key]


def is_writer(mesh) -> bool:
    """Whether this process writes the run's files: always without a mesh,
    rank 0 alone under one."""
    return mesh is None or dist.get_rank() == 0


def device_from_args(args) -> torch.device:
    """The --device flag as a torch device; stops the run when it names
    CUDA and CUDA is absent (no fallback to the CPU)."""
    try:
        return resolve_device(args.device)
    except RuntimeError as exc:
        raise SystemExit(f"error: {exc} (on the command line: --device cpu)") from exc


def config_from_args(args) -> CodecConfig:
    return CodecConfig(
        K=args.K,
        split_ratio=args.split_ratio,
        precision=args.precision,
        model=ModelSpec(base_channel=args.base_channel, num_layers=args.num_layers),
        features=FeatureSpec(
            use_coords=args.use_coords,
            embedding=args.embedding,
            sigma=args.sigma,
            n_freq=args.n_freq,
            use_colors=not args.no_colors,
            relative=not args.abs_colors,
            D=args.D,
        ),
        train=TrainSpec(
            lr=args.lr,
            batch_size=args.batch_size,
            epochs=args.epochs,
            val_every=args.val_duration,
            seed=args.seed,
            schedule=args.schedule,
            sample_granule=args.sample_granule,
        ),
        base_codec=args.base_codec,
        weight_codec=args.weight_codec,
    )
