"""Profiling and phase timing.

- `PhaseTimer`: named host-side phase accounting (feature staging, train
  loop, host codecs, transfers) surfaced in EncodeStats/DecodeStats;
- `trace()`: a context manager around `torch.profiler` that writes a
  Chrome trace of the region (host ops and, on a CUDA run, the device's
  kernels and copies) into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator


class PhaseTimer:
    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (time.time() - t0)

    def report(self) -> str:
        total = sum(self.phases.values())
        parts = [f"{k}={v:.3f}s" for k, v in sorted(self.phases.items())]
        return f"total={total:.3f}s  " + " ".join(parts)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the region (CPU activity, and CUDA
    activity where a card is present) and write it to
    `log_dir/trace_<pid>_<ms>.json`, a Chrome trace that Perfetto or
    chrome://tracing opens."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    name = f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))
