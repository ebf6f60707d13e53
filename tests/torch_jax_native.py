"""Loads the JAX reference's native codec library once per pytest worker,
under a lock that every process shares (used by tests/test_torch_*.py).

The reference's loader (`lbdrn_msic_tpu/codecs/_native.py`) runs
`make -C codecs/native` in place whenever `liblbdrn_native.so` is missing or
older than its sources, guards that build with a thread lock only, and
remembers a failed load for the life of the process.  On a fresh checkout
the library does not exist yet, and xdist workers start the reference's
in-place build at the same moment while they collect the tests
(tests/test_native.py asks for the library at import).  A worker whose
`make` finds another worker's half-written library "up to date", or whose
`ctypes.CDLL` reads it while that worker's linker is still writing, keeps
None, and every test it then runs through the reference's LPC or LFPZ code
fails.

The port's parity test modules call `ensure_jax_native()` at import.  With
`--dist loadfile` each worker imports every test module before it runs any
test, so each worker ends its collection with the library loaded, whatever
its first, unlocked attempt gave.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import time

RETRY_S = 0.25  # pause between loads while another build may be writing the file


def ensure_jax_native(module=None, wait_s: float = 120.0):
    """Return the reference's native library, loaded in this process.

    `module` is the loader module (default `lbdrn_msic_tpu.codecs._native`;
    the tests pass a throwaway copy).  Under an exclusive `flock` on the
    library's source directory, shared by every process, it clears a
    remembered failure and calls the loader's `load()` (which rebuilds a
    stale library and loads it), retrying for up to `wait_s` seconds while
    another process's unlocked build may still be writing the file.  Raises
    RuntimeError with the output of one last `make` when the library never
    loads; it never skips and never falls back to another codec."""
    if module is None:
        from lbdrn_msic_tpu.codecs import _native as module
    if module._lib is not None:
        return module._lib
    fd = os.open(module._DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        deadline = time.monotonic() + wait_s
        while True:
            module._tried = False
            lib = module.load()
            if lib is not None:
                return lib
            if time.monotonic() >= deadline:
                break
            time.sleep(RETRY_S)
        make = subprocess.run(["make", "-C", module._DIR], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, timeout=120)
    finally:
        os.close(fd)  # releases the lock
    raise RuntimeError(f"the reference's native codec library did not load within {wait_s} s; "
                       f"make -C {module._DIR} (rc {make.returncode}):\n{make.stdout}")
