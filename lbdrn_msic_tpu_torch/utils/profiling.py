"""Profiling and phase timing.

- `PhaseTimer`: named host spans (`phase`, on a monotonic clock) and
  device spans (`device_phase`, CUDA events), surfaced as
  `EncodeStats.phases` / `DecodeStats.phases`: the codec's dispatch,
  device waits, host codecs and decode assembly, and inside `dispatch` the
  fit's staging, step issue and evals (codec.py names each).  Spans may
  close on several threads at once (the base coders' workers add
  `base_code` beside the caller's phases): each addition holds a lock.
  While a torch profiler runs, every host span is also a `phase:<name>`
  range on the profiler's clock;
- `trace()`: a context manager around `torch.profiler` that writes a
  Chrome trace of the region (host ops of every thread and, on a CUDA
  run, the device's kernels and copies) into a directory.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Dict, Iterator

import torch


class PhaseTimer:
    def __init__(self):
        self.phases: Dict[str, float] = {}
        self._lock = threading.Lock()

    def _add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.phases[name] = self.phases.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Adds the block's host seconds to `phases[name]`; while a torch
        profiler is enabled, the block is also the range `phase:<name>`."""
        rf = None
        if torch.autograd.profiler._is_profiler_enabled:  # a global flag, set on any thread
            rf = torch.profiler.record_function("phase:" + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)

    @contextlib.contextmanager
    def device_phase(self, name: str, device: torch.device) -> Iterator[Callable[[], None]]:
        """Adds the device seconds of the block's work on the current CUDA
        stream to `phases[name]`, adding no synchronisation where the block
        ends in one: an event is recorded on entry, and one where the block
        calls the `stop()` it is given, after its last operation and before
        the sync that ends the block; on exit the end event is waited for
        (already passed after that sync) and the two are read.  Off CUDA it
        records nothing."""
        if device.type != "cuda":
            yield lambda: None
            return
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        yield end.record
        end.synchronize()
        self._add(name, start.elapsed_time(end) / 1e3)


class NoTimer:
    """A `PhaseTimer` stand-in that records nothing."""

    def phase(self, name: str):
        return contextlib.nullcontext()

    def device_phase(self, name: str, device: torch.device):
        return contextlib.nullcontext(lambda: None)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the region (CPU activity of every
    thread, the decode's dispatch worker and the base codecs' pools too,
    and CUDA activity where a card is present) and write it to
    `log_dir/trace_<pid>_<ms>.json`, a Chrome trace that Perfetto or
    chrome://tracing opens."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
    name = f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))
