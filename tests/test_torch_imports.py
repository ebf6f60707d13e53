"""The PyTorch port stands alone: importing every port module (and
chip_smoke) loads no JAX, no optax and nothing of the JAX package; entry
points default to CUDA and raise where it is absent."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "lbdrn_msic_tpu_torch",
    "lbdrn_msic_tpu_torch.core.config",
    "lbdrn_msic_tpu_torch.io.header",
    "lbdrn_msic_tpu_torch.io.tiles",
    "lbdrn_msic_tpu_torch.codecs._native",
    "lbdrn_msic_tpu_torch.codecs.rangecoder",
    "lbdrn_msic_tpu_torch.codecs.weights",
    "lbdrn_msic_tpu_torch.codecs.lpc",
    "lbdrn_msic_tpu_torch.codecs.base_layer",
    "lbdrn_msic_tpu_torch.utils.synth",
    "lbdrn_msic_tpu_torch.utils.profiling",
    "lbdrn_msic_tpu_torch.utils.transfer",
    "lbdrn_msic_tpu_torch.eval.metrics",
    "lbdrn_msic_tpu_torch.models.siren",
    "lbdrn_msic_tpu_torch.ops._build",
    "lbdrn_msic_tpu_torch.ops.fused_step",
    "lbdrn_msic_tpu_torch.features.engine",
    "lbdrn_msic_tpu_torch.train.loop",
    "lbdrn_msic_tpu_torch.decode.reconstruct",
    "lbdrn_msic_tpu_torch.codec",
    "lbdrn_msic_tpu_torch.profiling",
    "lbdrn_msic_tpu_torch.profiling.kernel_prof",
    "lbdrn_msic_tpu_torch.profiling.step_prof",
    "lbdrn_msic_tpu_torch.profiling.mm_ab",
    "lbdrn_msic_tpu_torch.profiling.mfu_experts",
    "chip_smoke",
]

_CHECK = """
import importlib, sys
for m in {mods!r}:
    importlib.import_module(m)
bad = sorted(
    n for n in sys.modules
    if n in ("jax", "jaxlib", "optax", "cv2", "lbdrn_msic_tpu")
    or n.startswith(("jax.", "jaxlib.", "optax.", "lbdrn_msic_tpu."))
)
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK.format(mods=PORT_MODULES)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout


def test_prefix_rule_is_exact():
    """`lbdrn_msic_tpu_torch` starts with `lbdrn_msic_tpu`: the check above
    must match the JAX package by exact name or dotted prefix only."""
    is_jax_pkg = lambda n: n == "lbdrn_msic_tpu" or n.startswith("lbdrn_msic_tpu.")
    assert not is_jax_pkg("lbdrn_msic_tpu_torch")
    assert not is_jax_pkg("lbdrn_msic_tpu_torch.codec")
    assert is_jax_pkg("lbdrn_msic_tpu.codec")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from lbdrn_msic_tpu_torch.codec import decode_stream, encode_image
    from lbdrn_msic_tpu_torch.core.config import CodecConfig

    from lbdrn_msic_tpu_torch.profiling import kernel_prof, mfu_experts, mm_ab, step_prof

    img = np.zeros((1, 8, 8), np.uint16)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_image(img, CodecConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_stream(b"")
    # the profiling entry points: each refuses before any work
    ws, bs, x, y, mask = kernel_prof.make_inputs(batch=16, device="cpu")
    for run in (lambda: kernel_prof.run_steps(ws, bs, x, y, mask, "full_t", steps=1),
                kernel_prof.make_inputs, lambda: kernel_prof.main(["full_t"]),
                lambda: step_prof.main([]), lambda: mm_ab.main([]), lambda: mm_ab.ab(1),
                lambda: mfu_experts.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()
