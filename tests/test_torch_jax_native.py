"""tests/torch_jax_native.py: the JAX reference's native codec library is
loaded once per process, under a lock, whatever an unlocked first load gave.

(a) a worker whose loader remembers a failed load gets the library back and
the reference's LPC codec round-trips; (b) six processes that start the
reference's unlocked in-place build at the same moment on a fresh copy of
its sources all end with a library, and give the same LPC bytes as this
process; (c) a source that does not compile raises RuntimeError with the
compiler's message, never a skip; (d) a loaded library returns at once;
(e) the root conftest's `pytest_configure` loads the library in a process
whose unlocked first load lost the race; (f) importing the root conftest,
and calling its hook, imports no `jax`."""

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from lbdrn_msic_tpu.codecs import _native, lpc

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
ROOT_CONFTEST = os.path.join(REPO, "conftest.py")
sys.path.insert(0, HERE)
from torch_jax_native import ensure_jax_native  # noqa: E402

ensure_jax_native()

PROCS = 6

# One child: import the loader copy, wait for the go file, take the raw
# unlocked load (as tests/test_native.py's collection does), then the
# helper, then LPC-encode the shared input through the copy's library.
CHILD = r"""
import hashlib, importlib.util, json, os, sys, time
import numpy as np
sys.path.insert(0, {tests!r})
from torch_jax_native import ensure_jax_native
spec = importlib.util.spec_from_file_location("native_copy", {loader!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
while not os.path.exists({go!r}):
    time.sleep(0.002)
raw = mod.load() is not None
ensure_jax_native(module=mod)
from lbdrn_msic_tpu.codecs import lpc
lpc._native = mod
stream = lpc.encode(np.load({msb!r}))
print(json.dumps({{"raw": raw, "sha": hashlib.sha256(stream).hexdigest()}}))
"""


def _msb(seed=0):
    return np.random.default_rng(seed).integers(0, 1 << 7, size=(2, 24, 20), dtype=np.uint16)


def _loader_copy(tmp_path, name="native_copy"):
    """The reference's loader and its native sources (no library) in tmp_path;
    the loader imports only the standard library, so it runs from there."""
    pkg = tmp_path / "pkg"
    src = os.path.join(REPO, "lbdrn_msic_tpu", "codecs")
    shutil.copytree(os.path.join(src, "native"), pkg / "native",
                    ignore=shutil.ignore_patterns("*.so", "*.o"))
    shutil.copy(os.path.join(src, "_native.py"), pkg / "_native.py")
    spec = importlib.util.spec_from_file_location(name, str(pkg / "_native.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_poisoned_worker_recovers(monkeypatch):
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", True)
    assert _native.load() is None  # the remembered failure
    lib = ensure_jax_native()
    assert lib is not None and _native._lib is lib
    msb = _msb()
    for chunk_rows in (0, 8):
        np.testing.assert_array_equal(lpc.decode(lpc.encode(msb, chunk_rows=chunk_rows)), msb)


def test_concurrent_cold_builds_all_end_loaded(tmp_path):
    mod = _loader_copy(tmp_path)
    assert not os.path.exists(mod._SO)
    msb_path, go = str(tmp_path / "msb.npy"), str(tmp_path / "go")
    np.save(msb_path, _msb(1))
    code = CHILD.format(tests=HERE, loader=mod.__file__, go=go, msb=msb_path)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(PROCS)]
    open(go, "w").close()
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
    want = hashlib.sha256(lpc.encode(_msb(1))).hexdigest()  # this process's reference library
    assert [o["sha"] for o in outs] == [want] * PROCS, outs


def test_broken_source_raises_with_compiler_message(tmp_path):
    mod = _loader_copy(tmp_path, "native_broken")
    with open(os.path.join(mod._DIR, "lpc.cc"), "a") as f:
        f.write("\n#error lbdrn_deliberately_broken_source\n")
    with pytest.raises(BaseException) as info:
        ensure_jax_native(module=mod, wait_s=0.5)
    assert info.type is RuntimeError  # a skip or a fallback would fail here
    msg = str(info.value)
    assert "lbdrn_deliberately_broken_source" in msg and "make -C" in msg, msg
    assert mod._lib is None


def test_loaded_library_returns_at_once(tmp_path):
    lib = object()
    stub = types.SimpleNamespace(_lib=lib, _DIR=str(tmp_path / "absent"), load=None)
    assert ensure_jax_native(module=stub) is lib


def test_root_conftest_loads_after_a_lost_race(tmp_path, monkeypatch, pytestconfig):
    from lbdrn_msic_tpu import codecs

    mod = _loader_copy(tmp_path, "native_lost_race")
    # another worker's library, half-written: newer than the sources, unloadable
    with open(mod._SO, "wb") as f:
        f.write(b"\x7fELF")
    assert mod.load() is None and mod._tried and not mod.available()
    shutil.copy(_native._SO, mod._SO)  # that worker's linker finishes the file
    assert not mod.available()  # the loader keeps its failure for the process
    monkeypatch.setattr(codecs, "_native", mod)
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT_CONFTEST)
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    root.pytest_configure(pytestconfig)
    assert mod.available() and mod._lib is not None


def test_root_conftest_imports_no_jax():
    code = (
        "import importlib.util, json, sys\n"
        f"spec = importlib.util.spec_from_file_location('root_conftest', {ROOT_CONFTEST!r})\n"
        "root = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(root)\n"
        "jax = lambda: sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib'))\n"
        "imported = jax()\n"
        "root.pytest_configure(None)\n"
        "print(json.dumps([imported, jax()]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], []]
