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
    "lbdrn_msic_tpu_torch.eval.reports",
    "lbdrn_msic_tpu_torch.eval.anchors",
    "lbdrn_msic_tpu_torch.eval.bdr_anchors",
    "lbdrn_msic_tpu_torch.eval.dlpr_anchor",
    "lbdrn_msic_tpu_torch.utils.visualize",
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
    "lbdrn_msic_tpu_torch.io.tiff",
    "lbdrn_msic_tpu_torch.utils.logging",
    "lbdrn_msic_tpu_torch.utils.tboard",
    "lbdrn_msic_tpu_torch.utils.build_log",
    "lbdrn_msic_tpu_torch.cli",
    "lbdrn_msic_tpu_torch.cli.common",
    "lbdrn_msic_tpu_torch.cli.encode",
    "lbdrn_msic_tpu_torch.cli.decode",
    "lbdrn_msic_tpu_torch.cli.summarize",
    "lbdrn_msic_tpu_torch.cli.sweep",
    "lbdrn_msic_tpu_torch.cli.anchors",
    "lbdrn_msic_tpu_torch.cli.report",
    "lbdrn_msic_tpu_torch.cli.visualize",
    "lbdrn_msic_tpu_torch.scripts",
    "lbdrn_msic_tpu_torch.scripts.flagship_workload",
    "lbdrn_msic_tpu_torch.scripts.scale_check",
    "lbdrn_msic_tpu_torch.scripts.suite",
    "lbdrn_msic_tpu_torch.scripts.make_sample",
    "lbdrn_msic_tpu_torch.scripts.make_goldens",
    "lbdrn_msic_tpu_torch.scripts.substitute_anchors",
    "lbdrn_msic_tpu_torch.scripts.rd_validation",
    "lbdrn_msic_tpu_torch.scripts.recipe_study",
    "lbdrn_msic_tpu_torch.scripts.ablations",
    "lbdrn_msic_tpu_torch.scripts.repro_all",
    "lbdrn_msic_tpu_torch.scripts.bench",
    "lbdrn_msic_tpu_torch.profiling.multik_ab",
    "lbdrn_msic_tpu_torch.profiling.budget_ab",
    "lbdrn_msic_tpu_torch.parallel",
    "lbdrn_msic_tpu_torch.parallel.distributed",
    "lbdrn_msic_tpu_torch.parallel.shard",
    "lbdrn_msic_tpu_torch.parallel.halo",
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


def test_entry_points_default_to_cuda(tmp_path):
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
    # the validation studies' command lines stop before any work
    from lbdrn_msic_tpu_torch.profiling import multik_ab
    from lbdrn_msic_tpu_torch.scripts import (ablations, make_goldens, make_sample,
                                              rd_validation, recipe_study, repro_all,
                                              substitute_anchors)

    for mod in (make_sample, make_goldens, substitute_anchors, rd_validation, recipe_study,
                ablations, repro_all, multik_ab):
        with pytest.raises(SystemExit, match="CUDA is not available"):
            mod.main([] if mod in (repro_all, multik_ab) else ["--out", str(tmp_path / "out")])
    assert not os.listdir(tmp_path)
