"""Phase timing: named host-side phase accounting (feature staging, train
loop, host codecs, transfers) surfaced in EncodeStats/DecodeStats."""

from __future__ import annotations

import contextlib
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
