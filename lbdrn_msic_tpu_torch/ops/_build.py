"""Build and load the CUDA kernels of `csrc/` with `nvcc` + `ctypes`.

Each `.cu` source compiles on first use into one shared library with a
plain C interface under the package's build directory (`_build/`,
git-ignored), for `sm_90a`; the `.cuh` headers beside them are shared.
Nothing here runs at import time: a machine without `nvcc` imports the
package and uses the kernels' plain versions on CPU tensors.

A library is kept only while its stamp (`<library>.stamp` beside it) holds:
the compiler's version, the machine, the C library, the flags and the
inputs' contents (`build_stamp`).  So a build directory copied from another
machine, or left by another compiler, is rebuilt rather than loaded; the
host codecs (`codecs/_native.py`) follow the same rule.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict = {}
# library name -> {"source": path in the package, "seconds": s of the last
# build() call, "rebuilt": compiled (True) or loaded from its stamp (False),
# "ptxas": the compiler's output of a rebuild}
build_log: dict = {}


def log_build(name: str, source: str, seconds: float, rebuilt: bool, output: str = "") -> None:
    """Record one library's build() call in `build_log`."""
    build_log[name] = {"source": source, "seconds": seconds, "rebuilt": rebuilt,
                       "ptxas": output}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_stamp(compiler: str, flags, inputs) -> str:
    """What a built library depends on besides its path: `compiler
    --version`, the machine and C library, the flags, the inputs' bytes."""
    version = subprocess.run([compiler, "--version"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, timeout=60).stdout
    digest = hashlib.sha256()
    for path in sorted(inputs):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return json.dumps({"compiler": version.strip(), "machine": platform.machine(),
                       "libc": list(platform.libc_ver()), "flags": list(flags),
                       "inputs": digest.hexdigest()}, sort_keys=True)


def is_current(lib: str, stamp: str) -> bool:
    """The library exists and was built with exactly `stamp`."""
    try:
        with open(lib + ".stamp") as f:
            return f.read() == stamp and os.path.exists(lib)
    except OSError:
        return False


def compile_into(lib: str, cmd_without_output, stamp: str, timeout: int) -> str:
    """Run the compiler into a private temporary file, move it onto `lib`
    (a concurrent reader never sees half a library), then write its stamp.
    Returns the compiler's output; raises with it on failure."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib))
    os.close(fd)
    try:
        proc = subprocess.run([*cmd_without_output, "-o", tmp], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd_without_output[0]} failed for {lib}:\n{proc.stdout}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    fd, tmp = tempfile.mkstemp(suffix=".stamp", dir=os.path.dirname(lib))
    with os.fdopen(fd, "w") as f:
        f.write(stamp)
    os.replace(tmp, lib + ".stamp")
    return proc.stdout


def build(name: str, force: bool = False) -> str:
    """Compile csrc/<name>.cu to _build/lib<name>.so unless a library with
    the current stamp is there (or `force`); returns the library path.
    Raises with the compiler output on failure."""
    t0 = time.time()
    src = os.path.join(CSRC, name + ".cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    inputs = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    compiler = nvcc()
    stamp = build_stamp(compiler, NVCC_FLAGS, inputs)
    source = os.path.relpath(src, PKG_DIR)
    if not force and is_current(so, stamp):
        log_build(name, source, time.time() - t0, False)
        return so
    out = compile_into(so, [compiler, *NVCC_FLAGS, src], stamp, timeout=600)
    log_build(name, source, time.time() - t0, True, out)
    return so


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (built on first call; two
    sources build side by side).  A library that does not load is rebuilt
    once; a second failure raises."""
    with _lock:
        lib = _libs.get(name)
    if lib is None:
        try:
            lib = ctypes.CDLL(build(name))
        except OSError:
            lib = ctypes.CDLL(build(name, force=True))
        with _lock:
            lib = _libs.setdefault(name, lib)
    return lib
