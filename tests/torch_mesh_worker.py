"""One rank of a gloo world on the CPU for the port's mesh tests
(tests/test_torch_mesh*.py); it imports the port only, never JAX.

    python tests/torch_mesh_worker.py STORE RANK WORLD TASKS.pkl OUT_DIR

Joins the world through the file store STORE, runs the (name, task,
kwargs) entries of TASKS.pkl in order (every rank the same list, so the collectives
line up), and pickles {name: result} to OUT_DIR/rank{RANK}.pkl; a task
that raises records ("raised", type name, message).  `spawn_world` starts
the ranks and joins them with a timeout.
"""

from __future__ import annotations

import datetime
import io
import os
import pickle
import subprocess
import sys
import traceback
from contextlib import redirect_stdout

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GROUP_TIMEOUT_S = 60


def spawn_world(tmp_path, world: int, tasks, timeout: float = 240.0):
    """Run `tasks` on a world of `world` ranks; returns [rank results], or
    raises with the ranks' output when one fails or the join times out."""
    tmp_path = str(tmp_path)
    spec = os.path.join(tmp_path, "tasks.pkl")
    with open(spec, "wb") as f:
        pickle.dump(tasks, f)
    store = os.path.join(tmp_path, "store")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mesh_worker.py"), store,
                               str(r), str(world), spec, tmp_path], cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(
            f"--- rank {r} rc={p.returncode}\n{o}" for r, (p, o) in enumerate(zip(procs, outs))))
    res = []
    for r in range(world):
        with open(os.path.join(tmp_path, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


# --- tasks (each runs on every rank with the same kwargs; with ref=True,
# rank 0 also computes the single-process result, in this process's
# threading, which the CPU's matmuls depend on) -------------------------

def _meshes():
    import torch.distributed as dist

    from lbdrn_msic_tpu_torch.parallel.shard import make_mesh

    world = dist.get_world_size()
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    out = {"dp": make_mesh(dp=world, timeout=timeout), "ep": make_mesh(ep=world, timeout=timeout)}
    if world == 4:
        out["ep2dp2"] = make_mesh(dp=2, ep=2, timeout=timeout)
    return out


def _rank0():
    import torch.distributed as dist

    return dist.get_rank() == 0


def _np_params(p):
    return [t.detach().cpu().numpy().copy() for t in p.leaves()]


def _fit_out(res):
    return {"params": _np_params(res.params), "epoch_losses": res.epoch_losses.cpu().numpy(),
            "step_losses": res.step_losses.cpu().numpy(), "best_mse": res.best_mse,
            "best_epoch": res.best_epoch, "staging": res.staging,
            "staged_bytes": res.staged_bytes}


def _prep(img, K, D):
    import torch

    from lbdrn_msic_tpu_torch.features.engine import pad_plane, split_msb_lsb

    msb, lsb = split_msb_lsb(torch.from_numpy(img.astype(np.int32)), K)
    plane, scale = pad_plane(msb, D)
    return plane, scale, lsb


MSPEC_KW = {"base_channel": 32, "num_layers": 1}


def task_fit_dp(meshes, img, K, tspec, seed=None, init=None, perms=None, ref=False):
    from lbdrn_msic_tpu_torch.codec import tile_generator
    from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec
    from lbdrn_msic_tpu_torch.features.engine import lsb_scale
    from lbdrn_msic_tpu_torch.models.siren import params_from_numpy
    from lbdrn_msic_tpu_torch.parallel.shard import fit_dp
    from lbdrn_msic_tpu_torch.train.loop import fit

    fspec, mspec = FeatureSpec(), ModelSpec(**MSPEC_KW)
    plane, scale, lsb = _prep(img, K, fspec.D)
    C, H, W = img.shape
    args = lambda: (plane, scale, lsb, float(np.float32(lsb_scale(K))),
                    None if seed is None else tile_generator(seed, 0), fspec, mspec, tspec,
                    H, W, C)
    kw = lambda: dict(init=None if init is None else params_from_numpy(*init), perms=perms,
                      device="cpu")
    out = {"mesh": _fit_out(fit_dp(meshes["dp"], *args(), **kw()))}
    if ref and _rank0():
        out["ref"] = _fit_out(fit(*args(), use_fused=False, **kw()))
    return out


def task_fit_experts(meshes, mesh, img, Ks, tspec, seed=None, init=None, perms=None,
                     ref=False):
    import torch

    from lbdrn_msic_tpu_torch.codec import tile_generator
    from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec
    from lbdrn_msic_tpu_torch.models.siren import params_from_numpy
    from lbdrn_msic_tpu_torch.parallel.shard import fit_experts
    from lbdrn_msic_tpu_torch.train.loop import fit_rate_experts

    C, H, W = img.shape
    args = lambda: (torch.from_numpy(img.astype(np.int32)), Ks,
                    None if seed is None else tile_generator(seed, 0), FeatureSpec(),
                    ModelSpec(**MSPEC_KW), tspec, H, W, C)
    kw = lambda: dict(init=None if init is None else params_from_numpy(*init), perms=perms,
                      device="cpu")
    out = {"mesh": _fit_out(fit_experts(meshes[mesh], *args(), **kw()))}
    if ref and _rank0():
        out["ref"] = _fit_out(fit_rate_experts(*args(), **kw()))
    return out


def task_rate_points(meshes, mesh, img, cfgs, header_version=1, ref=False):
    from lbdrn_msic_tpu_torch.codec import encode_rate_points

    run = lambda m: [s for s, _ in encode_rate_points(img, cfgs, device="cpu", mesh=m,
                                                       header_version=header_version)]
    out = {"mesh": run(meshes[mesh])}
    if ref and _rank0():
        out["ref"] = run(None)
    return out


def task_dataset(meshes, mesh, jobs, bucket=False, seed=None, ref=False):
    from lbdrn_msic_tpu_torch.codec import encode_dataset

    run = lambda m: [s for s, _ in encode_dataset(jobs, seed=seed, bucket=bucket, device="cpu",
                                                   mesh=m)]
    out = {"mesh": run(meshes[mesh])}
    if ref and _rank0():
        out["ref"] = run(None)
    return out


def task_encode_image(meshes, img, cfg, bucket=False, ref=False):
    import warnings

    from lbdrn_msic_tpu_torch.codec import encode_image

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        stream, _ = encode_image(img, cfg, device="cpu", mesh=meshes["dp"], bucket=bucket)
    out = {"mesh": stream, "warnings": [str(x.message) for x in w]}
    if ref and _rank0():
        out["ref"] = encode_image(img, cfg, device="cpu")[0]
    return out


def task_decode(meshes, streams, pipelined=False, ref=False):
    from lbdrn_msic_tpu_torch.codec import decode_pipelined, decode_stream

    if pipelined:
        out = {"mesh": [img for img, _ in decode_pipelined(streams, mesh=meshes["dp"],
                                                             device="cpu")]}
    else:
        out = {"mesh": [decode_stream(s, device="cpu", mesh=meshes["dp"])[0] for s in streams]}
    if ref and _rank0():
        out["ref"] = [decode_stream(s, device="cpu")[0] for s in streams]
    return out


def task_reconstruct_sp(meshes, base, weights, biases, fspec, mspec, K, ref=False):
    from lbdrn_msic_tpu_torch.decode.reconstruct import reconstruct_np
    from lbdrn_msic_tpu_torch.models.siren import params_from_numpy
    from lbdrn_msic_tpu_torch.parallel.halo import reconstruct_sp

    params = params_from_numpy(weights, biases)
    out = {"mesh": reconstruct_sp(meshes["dp"], base, params, fspec, mspec, K, device="cpu")}
    if ref and _rank0():
        import torch

        out["ref"] = reconstruct_np(base, params, fspec, mspec, K, torch.device("cpu"))
    return out


def task_make_mesh(meshes, dp, ep):
    from lbdrn_msic_tpu_torch.parallel.shard import axis_rank, axis_size, make_mesh

    m = make_mesh(dp=dp, ep=ep)
    return {"ep": axis_size(m, "ep"), "dp": axis_size(m, "dp"),
            "ep_rank": axis_rank(m, "ep"), "dp_rank": axis_rank(m, "dp")}


def task_from_runtime(meshes, jobs):
    from lbdrn_msic_tpu_torch.parallel.distributed import JobScheduler

    s = JobScheduler.from_runtime()
    return {"world": s.num_processes, "rank": s.process_id, "mine": s.mine(jobs)}


def task_collect(meshes):
    import torch
    import torch.distributed as dist

    from lbdrn_msic_tpu_torch.parallel.distributed import collect

    t = torch.arange(3, dtype=torch.float32) + 10 * dist.get_rank()
    return {"sum": collect(t, None).numpy(), "gather": collect(t, None, "gather").numpy()}


def task_cli(meshes, argvs):
    """Each (command, argv) through the command line's main(), stdout
    captured."""
    import importlib

    out = []
    for mod, argv in argvs:
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = importlib.import_module(f"lbdrn_msic_tpu_torch.cli.{mod}").main(argv)
        out.append((rc, buf.getvalue()))
    return out


TASKS = {k[len("task_"):]: v for k, v in dict(globals()).items() if k.startswith("task_")}


def main(argv):
    store, rank, world, spec, out_dir = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from lbdrn_msic_tpu_torch.parallel.distributed import initialize_cluster

    initialize_cluster(init_method=f"file://{store}", num_processes=world, process_id=rank,
                       device="cpu", timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    with open(spec, "rb") as f:
        tasks = pickle.load(f)
    meshes = _meshes()
    results = {}
    for name, fn, kwargs in tasks:
        try:
            results[name] = TASKS[fn](meshes, **kwargs)
        except Exception as exc:  # recorded for the test to judge
            results[name] = ("raised", type(exc).__name__, str(exc))
            traceback.print_exc()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main(sys.argv[1:])
