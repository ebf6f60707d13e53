"""ctypes loader for the native host codec library.

Compiles the C++ sources shipped in `codecs/native/` with `g++` into the
package's build directory (`lbdrn_msic_tpu_torch/_build/`, git-ignored) on
first use; the source tree itself is never written.  Concurrent first uses
(several test processes) each compile to a private temporary file and
`os.replace` it into place, so a reader never sees a half-written library.
`load()` returns None when the library cannot be built; the weight codec
then uses its pure-Python mirror.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

_DIR = os.path.join(os.path.dirname(__file__), "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
_SO = os.path.join(BUILD_DIR, "liblbdrn_native.so")
SOURCES = ("fpzcodec.cc", "lpc.cc", "assemble.cc")
_HEADERS = ("rangecoder.h",)
_lock = threading.Lock()
_lib = None
_tried = False


def _stale() -> bool:
    if not os.path.exists(_SO):
        return True
    t = os.path.getmtime(_SO)
    return any(
        os.path.getmtime(os.path.join(_DIR, f)) > t for f in SOURCES + _HEADERS
    )


def build() -> str:
    """Compile the library if it is missing or older than its sources;
    returns its path.  Raises on a compiler failure."""
    if not _stale():
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread",
             *[os.path.join(_DIR, f) for f in SOURCES], "-o", tmp],
            check=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            timeout=300,
        )
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _SO


def load():
    """Return the ctypes library, or None when it cannot be built."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(build())
        except (OSError, subprocess.SubprocessError):
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
        lib.lbdrn_assemble_residual.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_uint64,
        ]
        _lib = lib
        return _lib

