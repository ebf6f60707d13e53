"""The port's memory plan for the card: `pick_staging`, `plan_rate_points`,
`_plan_group` and the double-buffering gate at the Gaofen scenes' real
shapes, under the card's staging budget (half the card's 80 GB).

No image is allocated: every array is a `np.broadcast_to` view of one
12-bit sample (4095) at the real shape.  Tolerances: the plans are integer
arithmetic, compared exactly.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from lbdrn_msic_tpu_torch import codec
from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
from lbdrn_msic_tpu_torch.scripts.flagship_workload import SCENES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GiB = 1 << 30
CFG = CodecConfig(train=TrainSpec(sample_granule=8))  # the bench config: D=2, g=8
GF2, PMS, WFI = (4, 7605, 7815), (4, 6000, 6000), (8, 6000, 6000)


def _img(C, H, W):
    return np.broadcast_to(np.uint16(4095), (C, H, W))


def _cfgs(ks):
    return [dataclasses.replace(CFG, K=K) for K in ks]


def test_budget_is_half_the_card():
    assert codec.STAGE_BUDGET_BYTES == 40 * GiB
    assert codec.OVERLAP_BUDGET_BYTES == codec.STAGE_BUDGET_BYTES
    # the JAX package's TPU fences are not part of the port's plan
    assert not hasattr(codec, "SERIAL_SCENE_BYTES")


@pytest.mark.parametrize("shape,want", [(GF2, "full"), (PMS, "cached"), (WFI, "full"),
                                        ((4, 2048, 2048), "cached")])
def test_pick_staging_at_gaofen_shapes(shape, want):
    C, H, W = shape
    for K in range(1, 7):
        got, _ = codec.pick_staging(H, W, C, 4095 >> K, CFG.features, CFG.train, warn=False)
        assert got == want, (shape, K, got)


def test_plan_rate_points_gf2_one_full_group():
    staging, _, groups, per = codec.plan_rate_points(_img(*GF2), _cfgs(range(3, 7)))
    assert staging == "full" and groups == [[0, 1, 2, 3]]
    assert sum(per) <= codec.STAGE_BUDGET_BYTES
    assert round(sum(per) / GiB, 2) == 33.21


def _plan(shape, ks):
    cfgs = _cfgs(ks)
    return codec._plan_group([_img(*shape)], [(0, c) for c in cfgs], True, 16)


@pytest.mark.parametrize("ks,want", [
    (range(3, 7), {GF2: [4], WFI: [3, 1], PMS: [4]}),
    (range(1, 7), {GF2: [3, 3], WFI: [2, 3, 1], PMS: [6]}),
])
def test_plan_group_at_flagship_buckets(ks, want):
    """At the buckets (GF-2 7680x8192, GF-6 6144^2) every scene's K points
    train "full" in chunks packed up to the budget: the budget whole (no
    halving), more than one expert a chunk (no one-expert cap), each
    chunk's taps plus its image and label store within the budget."""
    for shape, sizes in want.items():
        plan = _plan(shape, ks)
        assert plan.staging == "full"
        assert plan.budget == codec.STAGE_BUDGET_BYTES
        assert [len(ch) for ch in plan.chunks] == sizes, (shape, plan.chunks)
        assert sorted(e for ch in plan.chunks for e in ch) == list(range(len(ks)))
        fixed = 4 * plan.H * plan.W * shape[0]
        for ch in plan.chunks:
            assert sum(plan.per_expert[e] for e in ch) + fixed <= plan.budget


def test_full_flagship_chunk_count():
    """The full flagship (13 scenes x K 1..6, one `encode_dataset` a
    scene) trains in 26 chunks: [3, 3] a GF-2 scene, [2, 3, 1] a WFI
    scene, [6] a PMS scene."""
    plans = {}
    for _, C, H, W in SCENES:
        if (C, H, W) not in plans:
            plans[C, H, W] = [len(ch) for ch in _plan((C, H, W), range(1, 7)).chunks]
    assert sum(len(plans[C, H, W]) for _, C, H, W in SCENES) == 26
    assert plans[4, 7340, 7815] == plans[GF2] == [3, 3]


def test_tiles_overlap_at_the_card_bound(monkeypatch):
    """GF-2 at split_ratio 2: four "cached" tiles whose two staging
    estimates and images stay below OVERLAP_BUDGET_BYTES, so the gate
    opens, and shuts at a bound equal to that sum (the rule is strict).  A
    12000^2 x 4 scene's 6000^2 "cached" tiles shut it."""
    cfg = dataclasses.replace(CFG, K=5, split_ratio=2)
    C, H, W = GF2
    tH, tW = H // 2 + H % 2, W // 2 + W % 2
    assert codec.pick_staging(tH, tW, C, 4095 >> 5, cfg.features, cfg.train)[0] == "cached"
    need = 2 * (codec._cached_bytes(tH, tW, C, cfg.features, 8) + C * tH * tW * 2)
    assert need < codec.OVERLAP_BUDGET_BYTES
    assert codec.tiles_overlap(GF2, 4095, 2, cfg)
    monkeypatch.setattr(codec, "OVERLAP_BUDGET_BYTES", need)
    assert not codec.tiles_overlap(GF2, 4095, 2, cfg)
    monkeypatch.setattr(codec, "OVERLAP_BUDGET_BYTES", need + 1)
    assert codec.tiles_overlap(GF2, 4095, 2, cfg)
    monkeypatch.undo()
    assert codec.pick_staging(6000, 6000, 4, 4095 >> 5, cfg.features, cfg.train)[0] == "cached"
    assert not codec.tiles_overlap((4, 12000, 12000), 4095, 2, cfg)


def test_budget_ab_needs_cuda(tmp_path):
    """`profiling/budget_ab.py`, run as a file on a tree (`--root`), stops
    with exit 1 and no JSON line where CUDA is absent."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "lbdrn_msic_tpu_torch", "profiling", "budget_ab.py"),
         "--root", REPO, "--cache", str(tmp_path)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and proc.stdout == "", (proc.returncode, proc.stdout)
    assert "CUDA is not available" in proc.stderr
