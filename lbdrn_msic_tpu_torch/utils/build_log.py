"""Build-time accounting: the port's counterpart of the JAX package's
per-program compile log.

The port compiles nothing at run time but its libraries: the CUDA kernels
(`ops/_build.py`, nvcc) and the native host codecs (`codecs/_native.py`,
g++), each built on first use or loaded from its stamp.  Both record every
build() call in `ops/_build.build_log`; `BuildLog` keeps the calls made
inside it:

    from lbdrn_msic_tpu_torch.utils.build_log import BuildLog
    with BuildLog() as bl:
        ...  # anything that loads a library
    print(bl.report())
"""

from __future__ import annotations

from lbdrn_msic_tpu_torch.ops import _build


class BuildLog:
    """Context manager: the library builds (and stamp loads) made inside."""

    def __init__(self) -> None:
        self._before: dict = {}
        self.events: dict = {}  # library name -> its build_log entry

    def __enter__(self) -> "BuildLog":
        self._before = dict(_build.build_log)
        return self

    def __exit__(self, *exc) -> None:
        self.events = {k: v for k, v in _build.build_log.items()
                       if self._before.get(k) is not v}

    def total(self) -> float:
        """Seconds of every build() call inside, stamp checks included."""
        return sum(e["seconds"] for e in self.events.values())

    def built(self) -> int:
        """Libraries compiled inside (not loaded from their stamp)."""
        return sum(1 for e in self.events.values() if e["rebuilt"])

    def report(self) -> str:
        lines = ["library build log (source, seconds, rebuilt or loaded from stamp):"]
        for name, e in sorted(self.events.items()):
            how = "rebuilt" if e["rebuilt"] else "loaded from stamp"
            lines.append(f"  {name:<14} {e['source']:<48} {e['seconds']:8.2f}s  {how}")
        if not self.events:
            lines.append("  (no library was built or loaded in this run; "
                         "an earlier call of this process loaded them)")
        lines.append(f"  total {self.total():.2f}s, {self.built()} built")
        return "\n".join(lines)
