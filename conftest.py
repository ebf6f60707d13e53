"""Loads the JAX reference's native codec library before any test module is
collected.

tests/test_native.py decides its module-level `skipif` from an unlocked,
in-place build of the library at import; on a fresh checkout, xdist
workers that collect it at the same moment can meet a half-written library
and skip its tests.  `pytest_configure` runs in the xdist controller
before it starts any worker, and in each worker before its collection, so
the library is built once, under the lock of `tests/torch_jax_native.py`,
and every worker finds it loaded.  Importing this file imports no `jax`.
"""

import importlib.util
import os

_HELPER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_jax_native.py")


def pytest_configure(config):
    spec = importlib.util.spec_from_file_location("torch_jax_native", _HELPER)
    helper = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helper)
    helper.ensure_jax_native()
