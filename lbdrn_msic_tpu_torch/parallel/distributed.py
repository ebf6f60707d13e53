"""Multi-process execution: the torch.distributed world and job partitioning.

- `initialize_cluster()` wires `torch.distributed` from torchrun's
  environment (MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE, LOCAL_RANK
  for the card) or from explicit arguments, one process per card.  After
  it, `parallel.shard.make_mesh` builds the ("ep", "dp") mesh of the
  world's ranks.  It is a no-op when nothing is configured, as the JAX
  package's `jax.distributed` wiring is.
- `JobScheduler` partitions an embarrassingly parallel job list across
  processes deterministically; the processes share artifacts through a
  shared filesystem, and the per-run log markers make every job resumable
  (the reference's run.sh sweep, run.sh:29-40, across machines).
  `JobScheduler.from_runtime()` reads the partition from the initialised
  world.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
from typing import Callable, List, Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

T = TypeVar("T")

# every process group gets a finite timeout: a rank that fails or diverges
# makes its peers' collectives raise instead of hanging
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def initialize_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    init_method: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> Optional[torch.device]:
    """Initialise the default process group; returns this rank's device,
    or None when nothing is configured (single process, no group).

    `coordinator_address` ("host:port"), `num_processes` and `process_id`
    override MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK; `init_method`
    (e.g. "file:///shared/store") replaces the address.  `device` defaults
    to ``cuda:{LOCAL_RANK}``, which becomes the current CUDA device;
    `backend` defaults to "nccl" for a CUDA device and "gloo" for the CPU.
    An already initialised world is left as it is."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if init_method is None and coordinator_address is None:
        return None
    dev = torch.device(device if device is not None
                       else f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or f"tcp://{coordinator_address}",
        world_size=world, rank=rank, timeout=timeout,
    )
    return dev


def collect(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The port's one tensor collective over `group`, on t's device:
    "sum", the element-wise sum over the ranks (t's shape); "gather", every
    rank's t stacked in group-rank order ((group size, *t.shape)).  Under
    NCCL the tensor stays where it is; under gloo it goes through host
    memory.  The group's backend decides, never a failure."""
    host = dist.get_backend(group) == "gloo"
    src = (t.detach().cpu() if host else t.detach()).contiguous()
    if op == "sum":
        out = src.clone()
        dist.all_reduce(out, group=group)
    elif op == "gather":
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        out = torch.stack(parts)
    else:
        raise ValueError(f"unknown collective {op!r}")
    return out.to(t.device) if host else out


def collect_objects(obj, group) -> list:
    """Every rank's picklable `obj` over `group`, in group-rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


@dataclasses.dataclass
class JobScheduler:
    """Deterministic static partition of independent jobs across processes.

    `done` (artifact existence) gives per-job idempotent resume, matching
    the reference's log-marker scheme (reference encode.py:216-224).
    """

    num_processes: int = 1
    process_id: int = 0

    @classmethod
    def from_runtime(cls) -> "JobScheduler":
        """(world size, rank) of the initialised world; (1, 0) without one."""
        if not dist.is_initialized():
            return cls()
        return cls(num_processes=dist.get_world_size(), process_id=dist.get_rank())

    def mine(self, jobs: Sequence[T]) -> List[T]:
        return [j for i, j in enumerate(jobs) if i % self.num_processes == self.process_id]

    def run(
        self,
        jobs: Sequence[T],
        work: Callable[[T], None],
        done: Optional[Callable[[T], bool]] = None,
        retries: int = 0,
    ) -> List[T]:
        """Run this process's share; returns the jobs it executed.

        `retries`: per-job retry budget for transient failures — the job
        re-runs up to `retries` extra times before its exception
        propagates.  With a `done` marker this composes with sweep-level
        resume: a job that completed between attempts is skipped on retry.
        """
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        ran = []
        for job in self.mine(jobs):
            if done is not None and done(job):
                continue
            for attempt in range(retries + 1):
                if attempt and done is not None and done(job):
                    break
                try:
                    work(job)
                    break
                except Exception as e:
                    if attempt == retries:
                        raise
                    print(
                        f"[scheduler] job {job!r} attempt {attempt + 1} "
                        f"failed ({type(e).__name__}: {e}); retrying",
                        file=sys.stderr,
                    )
            ran.append(job)
        return ran
