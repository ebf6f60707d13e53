"""Build-directory rules of the port's native libraries: a library is kept
only while its stamp (compiler version, machine, C library, flags, the
inputs' bytes) matches, a library that does not load is rebuilt once, and
a failed load keeps its cause.  The host codecs build here with g++; the
CUDA build runs a stand-in compiler (there is no nvcc here)."""

import json
import os
import stat
import sys

import pytest

from lbdrn_msic_tpu_torch.codecs import _native
from lbdrn_msic_tpu_torch.ops import _build


@pytest.fixture
def native_dir(tmp_path, monkeypatch):
    """A fresh, empty build directory for the host codec library."""
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", False)
    monkeypatch.setattr(_native, "load_error", None)
    return tmp_path


def _native_stamp():
    return _build.build_stamp("g++", _native._FLAGS,
                              [os.path.join(_native._DIR, f)
                               for f in _native.SOURCES + _native._HEADERS])


@pytest.mark.parametrize("stamp", ["foreign", "current", "none"])
def test_native_library_from_elsewhere_is_rebuilt(native_dir, stamp):
    """A corrupt library beside another machine's stamp, beside the
    current stamp (it fails to load, so it is rebuilt once), or with no
    stamp at all: `load()` rebuilds it and loads, and the stamp is then
    this machine's."""
    so = native_dir / "liblbdrn_native.so"
    so.write_bytes(b"not a shared library")
    if stamp != "none":
        text = _native_stamp()
        if stamp == "foreign":
            text = json.dumps({**json.loads(text), "machine": "elsewhere"})
        (native_dir / "liblbdrn_native.so.stamp").write_text(text)
    lib = _native.load()
    assert lib is not None, _native.load_error
    assert _native.load_error is None
    assert so.read_bytes() != b"not a shared library"
    assert (native_dir / "liblbdrn_native.so.stamp").read_text() == _native_stamp()
    before = so.stat().st_mtime_ns
    assert _native.build() == str(so)  # current: kept as it is
    assert so.stat().st_mtime_ns == before


def test_native_load_keeps_its_cause(native_dir, tmp_path_factory, monkeypatch):
    """Sources that do not compile: `load()` returns None and `load_error`
    holds the compiler's message."""
    src = tmp_path_factory.mktemp("src")
    for f in _native.SOURCES + _native._HEADERS:
        (src / f).write_text("this is not C++\n")
    monkeypatch.setattr(_native, "_DIR", str(src))
    assert _native.load() is None
    assert "RuntimeError" in _native.load_error and "g++ failed" in _native.load_error


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """csrc/ with one source, an empty build directory, and a stand-in
    nvcc that writes a non-library and logs each compile."""
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    (csrc / "common.cuh").write_text("// header\n")
    log = tmp_path / "compiles.log"
    tool = tmp_path / "nvcc"
    tool.write_text(
        f"#!{sys.executable}\n"
        "import os, sys\n"
        "if '--version' in sys.argv:\n"
        "    print(os.environ.get('FAKE_NVCC_VERSION', 'nvcc 12.9'))\n"
        "    sys.exit(0)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('not a library')\n"
        f"open({str(log)!r}, 'a').write('compile\\n')\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(_build, "nvcc", lambda: str(tool))
    monkeypatch.setattr(_build, "_libs", {})
    compiles = lambda: len(log.read_text().splitlines()) if log.exists() else 0
    return csrc, build, compiles


def test_cuda_library_rebuilt_when_its_stamp_differs(fake_nvcc, monkeypatch):
    """The kernels' libraries follow the same rule: built once, kept while
    the stamp holds, rebuilt for another machine's stamp, another compiler
    version, or changed source or header bytes."""
    csrc, build, compiles = fake_nvcc
    so = _build.build("k")
    assert so == str(build / "libk.so") and compiles() == 1
    assert _build.build("k") == so and compiles() == 1
    stamp = build / "libk.so.stamp"
    stamp.write_text(json.dumps({**json.loads(stamp.read_text()), "machine": "elsewhere"}))
    _build.build("k")
    assert compiles() == 2
    monkeypatch.setenv("FAKE_NVCC_VERSION", "nvcc 13.0")
    _build.build("k")
    assert compiles() == 3
    (csrc / "common.cuh").write_text("// header, edited\n")
    _build.build("k")
    assert compiles() == 4
    assert _build.build("k") == so and compiles() == 4


def test_cuda_library_that_does_not_load_is_rebuilt_once(fake_nvcc):
    """A library that does not load is rebuilt once; the second failure
    raises with the loader's message."""
    _, _, compiles = fake_nvcc
    with pytest.raises(OSError):
        _build.load("k")
    assert compiles() == 2
