"""ctypes loader for the native host codec library.

Compiles the C++ sources shipped in `codecs/native/` (the weight and base
codecs, the residual assembly, the TIFF chunk decoders) with `g++` into the
package's build directory (`lbdrn_msic_tpu_torch/_build/`, git-ignored) on
first use; the source tree itself is never written.  Concurrent first uses
(several test processes) each compile to a private temporary file and
`os.replace` it into place, so a reader never sees a half-written library.
A library is kept only while its stamp matches this machine, compiler and
sources (`ops/_build.py::build_stamp`, the rule of the CUDA libraries), so
a build directory copied from another machine is rebuilt.  `load()`
returns None when the library cannot be built or loaded, and keeps the
cause in `load_error`; the weight codec then uses its pure-Python mirror.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

from lbdrn_msic_tpu_torch.ops._build import build_stamp, compile_into, is_current, log_build

_DIR = os.path.join(os.path.dirname(__file__), "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
SOURCES = ("fpzcodec.cc", "lpc.cc", "assemble.cc", "tiffcodecs.cc")
_HEADERS = ("rangecoder.h",)
_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False
load_error = None  # why the last load() returned None


def build(force: bool = False) -> str:
    """Compile the library unless one with the current stamp is there (or
    `force`); returns its path.  Raises on a compiler failure."""
    t0 = time.time()
    so = os.path.join(BUILD_DIR, "liblbdrn_native.so")
    stamp = build_stamp("g++", _FLAGS, [os.path.join(_DIR, f) for f in SOURCES + _HEADERS])
    rebuilt = force or not is_current(so, stamp)
    out = ""
    if rebuilt:
        out = compile_into(so, ["g++", *_FLAGS, *[os.path.join(_DIR, f) for f in SOURCES]],
                           stamp, timeout=300)
    log_build("lbdrn_native", "codecs/native/" + ",".join(SOURCES), time.time() - t0,
              rebuilt, out)
    return so


def load():
    """Return the ctypes library, or None when it cannot be built or
    loaded (the cause in `load_error`).  A library that does not load is
    rebuilt once."""
    global _lib, _tried, load_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            try:
                lib = ctypes.CDLL(build())
            except OSError:
                lib = ctypes.CDLL(build(force=True))
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            load_error = f"{type(exc).__name__}: {exc}"
            return None

        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.lbdrn_free.argtypes = [ctypes.c_void_p]
        lib.lfpz_compress.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.lfpz_peek.argtypes = [
            u8p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int),
        ]
        lib.lfpz_decompress.argtypes = [
            u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
        ]
        lib.lpc_compress.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.lpc_peek.argtypes = [
            u8p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.lpc_decompress.argtypes = [
            u8p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint16), ctypes.c_uint64,
        ]
        lib.lpc_compress2.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.lpc_peek2.argtypes = [
            u8p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.lpc_decompress_chunk.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_uint64,
        ]
        for name in ("lbdrn_lzw_decode", "lbdrn_packbits_decode"):
            fn = getattr(lib, name)
            fn.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
            fn.restype = ctypes.c_int64
        lib.lbdrn_assemble_residual.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_uint64,
        ]
        _lib = lib
        return _lib

