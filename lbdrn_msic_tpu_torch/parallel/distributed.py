"""Job partitioning across cooperating processes (a copy of the JAX
package's framework-free `JobScheduler`).

`JobScheduler` partitions an embarrassingly parallel job list across
processes deterministically; the processes share artifacts through a shared
filesystem, and the per-run log markers make every job resumable (the
reference's run.sh sweep, run.sh:29-40, across machines).  Reading the
partition from a distributed runtime (`from_runtime`, `initialize_cluster`)
belongs to multi-card parallelism, which is not ported yet (ROADMAP queue 6).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, List, Optional, Sequence, TypeVar

T = TypeVar("T")


@dataclasses.dataclass
class JobScheduler:
    """Deterministic static partition of independent jobs across processes.

    `done` (artifact existence) gives per-job idempotent resume, matching
    the reference's log-marker scheme (reference encode.py:216-224).
    """

    num_processes: int = 1
    process_id: int = 0

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
