"""Sweep CLI — the reference's run.sh (images x K rate points) as a command.

Reference run.sh:29-40 loops `python encode.py ...; python decode.py ...`
over images x K as separate shell processes, resumable through the per-run
log markers.  The same structure here, in one process on the card
(`--device cpu` runs on the CPU), with the JAX package's flags, run
directories, log lines and resume markers:

    python -m lbdrn_msic_tpu_torch.cli.sweep -i a.tif b.tif -o outputs \\
        --k-min 3 --k-max 6 --batch-experts --base-codec lpc

`--pipeline` encodes job after job with the host work overlapped
(`codec.encode_pipelined`); `--batch-experts` trains (image, K) jobs as
experts (`codec.encode_dataset`); both decode through
`codec.decode_pipelined_iter`.  `--hosts` / `--host-id` split the jobs
across processes sharing a filesystem; `--distributed` takes them from the
torch.distributed world of torchrun's processes, each of which then runs
its own share of the jobs on its own card.  `--mesh dp=N[,ep=M]` runs
every job on all of torchrun's processes together instead: the per-job
path hands it to each encode and decode, `--batch-experts` fans the
experts out over the ep axis (`codec.encode_dataset(mesh=)`); rank 0 alone
writes.  The two cannot share one world: `--distributed` gives each rank
different jobs, while a mesh needs every rank in every job.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from lbdrn_msic_tpu_torch.cli import decode as decode_cli
from lbdrn_msic_tpu_torch.cli import encode as encode_cli
from lbdrn_msic_tpu_torch.cli.common import (
    add_codec_args,
    config_from_args,
    device_from_args,
    is_writer,
    mesh_from_args,
)
from lbdrn_msic_tpu_torch.parallel.distributed import JobScheduler, initialize_cluster
from lbdrn_msic_tpu_torch.parallel.shard import axis_size


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="LBDRN-MSIC RD sweep (PyTorch/CUDA)")
    p.add_argument("-i", "--paths", nargs="+", required=True,
                   help="input tif files")
    p.add_argument("-o", "--output_dir", type=str, default="outputs")
    p.add_argument("--k-min", type=int, default=1)
    p.add_argument("--k-max", type=int, default=11)
    p.add_argument("--pipeline", action="store_true",
                   help="cross-job pipelined encoding (codec.encode_pipelined): "
                        "job i+1's upload and training overlap job i's host "
                        "codecs; byte-identical streams")
    p.add_argument("--batch-experts", action="store_true",
                   help="train (image, K) jobs together as experts "
                        "(codec.encode_dataset), filling the expert axis across "
                        "images of one shape; byte-identical to per-job runs")
    p.add_argument("--retries", type=int, default=0,
                   help="per-(image,K) retry budget for transient failures; "
                        "completed halves are skipped via the CLIs' resume markers")
    p.add_argument("--hosts", type=int, default=1,
                   help="partition the (image, K) job list across N cooperating "
                        "processes writing to a shared filesystem (the "
                        "reference's run.sh fan-out); per-run resume markers keep "
                        "it idempotent")
    p.add_argument("--host-id", type=int, default=None,
                   help="this process's 0-based index among --hosts (default 0)")
    p.add_argument("--distributed", action="store_true",
                   help="initialize torch.distributed from torchrun's "
                        "MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE and take "
                        "--hosts/--host-id from the world (each rank on "
                        "cuda:LOCAL_RANK)")
    add_codec_args(p, encode=True)
    args = p.parse_args(argv)
    device = device_from_args(args)
    if args.distributed and args.mesh:
        raise SystemExit(
            "--distributed and --mesh cannot share one world: --distributed gives each "
            "rank its own share of the jobs, while --mesh needs every rank in every "
            "job; use one of them")
    mesh = mesh_from_args(args)

    if args.pipeline or args.batch_experts:
        if args.retries:
            print("[sweep] note: --retries applies to the per-job scheduler "
                  "path only; --pipeline/--batch-experts rely on rerunning "
                  "the sweep (completed jobs resume-skip)", flush=True)
        return _pipelined_sweep(args, device, mesh)

    sched = _scheduler_from_args(args)

    base_flags = []
    for flag, val in [
        ("-sr", args.split_ratio), ("-bc", args.base_channel),
        ("-nl", args.num_layers), ("-D", args.D), ("-prec", args.precision),
        ("-lr", args.lr), ("-bs", args.batch_size), ("-e", args.epochs),
        ("-vd", args.val_duration), ("--seed", args.seed),
        ("--sigma", args.sigma), ("--n-freq", args.n_freq),
        ("--base-codec", args.base_codec), ("--weight-codec", args.weight_codec),
        ("--header-version", args.header_version),
        ("--schedule", args.schedule), ("-g", args.sample_granule),
        ("--device", args.device),
    ]:
        base_flags += [flag, str(val)]
    for flag, on in [
        ("--use-coords", args.use_coords), ("--embedding", args.embedding),
        ("--no-colors", args.no_colors), ("--abs-colors", args.abs_colors),
        ("-rn", args.randomness), ("--compile-log", args.compile_log),
        ("--bucket", args.bucket),
    ]:
        if on:
            base_flags.append(flag)
    mesh_flags = ["--mesh", args.mesh] if args.mesh else []

    grid = [(path, K) for path in args.paths for K in range(args.k_min, args.k_max + 1)]

    def work(job):
        path, K = job
        stem = os.path.splitext(os.path.basename(path))[0]
        enc_args = ["-i", path, "-o", args.output_dir, "-K", str(K)] + base_flags + mesh_flags
        if is_writer(mesh):
            print(f"[sweep] encode {stem} K={K}")
        encode_cli.main(enc_args)
        cfg = dataclasses.replace(config_from_args(args), K=K)
        run_dir = os.path.join(args.output_dir, cfg.run_name(stem))
        bin_path = os.path.join(run_dir, f"{stem}.bin")
        if is_writer(mesh):
            print(f"[sweep] decode {stem} K={K}")
        decode_cli.main(["-i", bin_path, "-org", path, "--device", args.device] + mesh_flags)

    # the encode/decode CLIs are themselves idempotent (log-marker resume),
    # so retried jobs skip completed halves
    sched.run(grid, work, retries=args.retries)
    return 0


def _scheduler_from_args(args) -> JobScheduler:
    """JobScheduler from --hosts/--host-id, or with --distributed from the
    torch.distributed world (`initialize_cluster` from torchrun's
    environment; a single process without one)."""
    if args.distributed:
        initialize_cluster(device=None if args.device == "cuda" else args.device)
        return JobScheduler.from_runtime()
    host_id = 0 if args.host_id is None else args.host_id
    if not (0 <= host_id < args.hosts):
        raise SystemExit(f"--host-id {host_id} not in [0, {args.hosts})")
    return JobScheduler(num_processes=args.hosts, process_id=host_id)


def _run_dir(args, base_cfg, path, K):
    stem = os.path.splitext(os.path.basename(path))[0]
    run_dir = os.path.join(args.output_dir, dataclasses.replace(base_cfg, K=K).run_name(stem))
    return stem, run_dir, os.path.join(run_dir, f"{stem}.bin")


def _pipelined_sweep(args, device, mesh=None) -> int:
    from lbdrn_msic_tpu_torch.codec import decode_pipelined_iter, encode_dataset, encode_pipelined
    from lbdrn_msic_tpu_torch.io.tiff import read_tiff
    from lbdrn_msic_tpu_torch.utils.logging import RunLogger, run_is_complete

    sched = _scheduler_from_args(args)
    Ks = range(args.k_min, args.k_max + 1)
    # batch-experts batches a whole image's rate points, so it partitions by
    # image; the per-(image, K) pipeline partitions by job
    if args.batch_experts:
        my_paths = sched.mine(args.paths)
        my_jobs = {(p, K) for p in my_paths for K in Ks}
    else:
        my_jobs = set(sched.mine([(p, K) for p in args.paths for K in Ks]))
        my_paths = [p for p in args.paths if any((p, K) in my_jobs for K in Ks)]

    base_cfg = config_from_args(args)
    jobs, meta = [], []
    for path in my_paths:
        img = None
        for K in Ks:
            if (path, K) not in my_jobs:
                continue
            stem, run_dir, bin_path = _run_dir(args, base_cfg, path, K)
            if run_is_complete(run_dir, "encode.txt", "Time elapsed") and os.path.exists(bin_path):
                continue
            if img is None:
                img = read_tiff(path)
            jobs.append((img, dataclasses.replace(base_cfg, K=K)))
            meta.append((stem, run_dir, bin_path))

    writer = is_writer(mesh)
    if jobs:
        if args.batch_experts:
            if writer:
                print(f"[sweep] expert-batched encode of {len(jobs)} jobs"
                      + (f" over mesh ep={axis_size(mesh, 'ep')} x dp={axis_size(mesh, 'dp')}"
                         if mesh is not None else ""))
            # experts are (image, K) pairs: same-shape jobs batch together
            # across images, and over the mesh's ranks
            results = encode_dataset(jobs, header_version=args.header_version,
                                     bucket=args.bucket, device=device, mesh=mesh)
        else:
            if writer:
                print(f"[sweep] pipelined encode of {len(jobs)} jobs")
            results = encode_pipelined(jobs, bucket=args.bucket, device=device)
        if not writer:  # rank 0 writes the runs and decodes them
            return 0
        for (stem, run_dir, bin_path), (stream, stats) in zip(meta, results):
            os.makedirs(run_dir, exist_ok=True)
            log = RunLogger(run_dir, "encode.txt", to_stdout=False)
            encode_cli.write_encode_outputs(log, bin_path, stem, stream, stats,
                                            time.time() - stats.elapsed)
            log.close()

    # the decode half, cross-stream pipelined: stream i+1's host decodes and
    # device dispatch overlap stream i's fetch and assembly
    dec_meta = []
    for path in my_paths:
        for K in Ks:
            if (path, K) not in my_jobs:
                continue
            _, run_dir, bin_path = _run_dir(args, base_cfg, path, K)
            if not run_is_complete(run_dir, "decode.txt", "bpsp"):
                dec_meta.append((bin_path, path, run_dir))
    if dec_meta:
        t0 = time.time()

        def read_streams():  # lazy: at most the decode-ahead depth in memory
            for bin_path, _, _ in dec_meta:
                print(f"[sweep] decode {os.path.basename(bin_path)}")
                with open(bin_path, "rb") as f:
                    yield f.read()

        for (bin_path, path, run_dir), (rec, dstats) in zip(
                dec_meta, decode_pipelined_iter(read_streams(), device=device)):
            log = RunLogger(run_dir, "decode.txt", to_stdout=False)
            log.info(f"Binstream: {bin_path}")
            decode_cli.write_decode_outputs(log, bin_path, rec, dstats,
                                            time.time() - dstats.elapsed, org_path=path)
            log.close()
        print(f"[sweep] decoded {len(dec_meta)} streams in {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
