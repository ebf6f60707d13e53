"""Build and load the CUDA kernels of `csrc/` with `nvcc` + `ctypes`.

Each `.cu` source compiles on first use into one shared library with a
plain C interface under the package's build directory (`_build/`,
git-ignored), for `sm_90a`; the `.cuh` headers beside them are shared.
Nothing here runs at import time: a machine without `nvcc` imports the
package and uses the kernels' plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import os
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
build_log: dict = {}  # source name -> {"seconds": s, "ptxas": text}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(name: str) -> str:
    """Compile csrc/<name>.cu to _build/lib<name>.so when missing or older
    than the source or a header of csrc/; returns the library path.  Raises
    with the compiler output on failure."""
    src = os.path.join(CSRC, name + ".cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    inputs = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    if os.path.exists(so) and os.path.getmtime(so) >= max(map(os.path.getmtime, inputs)):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.time()
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_log[name] = {"seconds": time.time() - t0, "ptxas": proc.stdout}
    return so


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (built on first call)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
