"""Multi-tile encodes in the port: the double-buffering gate against the
JAX package's arithmetic, and the overlapped tile order against the
serial one.

Tolerances: the gate is integer arithmetic, equal exactly; the overlapped
and serial streams are equal byte for byte (same draws, same programs).
"""

import os
import sys
import warnings

import pytest

from lbdrn_msic_tpu import codec as jcodec
from lbdrn_msic_tpu.core.config import FeatureSpec as JFeatureSpec
from lbdrn_msic_tpu.core.config import TrainSpec as JTrainSpec
from lbdrn_msic_tpu_torch import codec
from lbdrn_msic_tpu_torch.core.config import CodecConfig, FeatureSpec, TrainSpec
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_native import ensure_jax_native  # noqa: E402

ensure_jax_native()  # the reference's native library: once per worker, under a lock

# (C, H, W, split_ratio, granule): tiles that open the gate (small, the
# GF-2 scene's "full" quarters, WFI quarters) and shut it (a cached tile
# near the budget at g=1, banded and gather tiles of huge scenes), and an
# untiled image
GATE_CASES = [
    (4, 64, 64, 2, 8),
    (4, 7605, 7815, 2, 8),
    (8, 6000, 6000, 2, 8),
    (4, 7600, 7600, 2, 1),
    (4, 24000, 24000, 2, 8),
    (4, 60000, 60000, 2, 8),
    (4, 7605, 7815, 3, 8),
    (4, 2048, 2048, 1, 8),
]


def _jax_gate(C, H, W, sr, g, K, relative, max_value=4095, itemsize=2):
    """JAX codec.encode_image's overlap rule (codec.py, `overlap_tiles`),
    recomputed from its own pick_staging / _cached_bytes / _staging_bytes."""
    if sr * sr <= 1:
        return False
    jfs, jts = JFeatureSpec(relative=relative), JTrainSpec(sample_granule=g)
    tH, tW = H // sr + H % sr, W // sr + W % sr
    st0, dt0 = jcodec.pick_staging(tH, tW, C, max_value >> K, jfs, jts, warn=False)
    g0 = max(1, g)
    if st0 == "cached":
        sbytes = jcodec._cached_bytes(tH, tW, C, jfs, g0)
    elif st0 in ("full", "banded"):
        fb, bb = jcodec._staging_bytes(tH, tW, C, jfs, g0, dt0, dt0)
        sbytes = fb if st0 == "full" else bb
    else:
        sbytes = 0
    return 2 * (sbytes + C * tH * tW * itemsize) < (12 << 30)


@pytest.mark.parametrize("K", [1, 3, 5])
def test_overlap_gate_matches_jax(K, monkeypatch):
    """At the JAX package's staging budget and overlap bound (12 GiB), the
    port's gate is the JAX package's on every case."""
    monkeypatch.setattr(codec, "STAGE_BUDGET_BYTES", jcodec.STAGE_BUDGET_BYTES)
    monkeypatch.setattr(codec, "OVERLAP_BUDGET_BYTES", 12 << 30)
    opened = set()
    for C, H, W, sr, g in GATE_CASES:
        for relative in (True, False):
            cfg = CodecConfig(K=K, split_ratio=sr, features=FeatureSpec(relative=relative),
                              train=TrainSpec(sample_granule=g))
            with warnings.catch_warnings():
                warnings.simplefilter("error")  # the estimate never warns
                got = codec.tiles_overlap((C, H, W), 4095, 2, cfg)
            assert got == _jax_gate(C, H, W, sr, g, K, relative), (C, H, W, sr, g, relative)
            opened.add(got)
    assert opened == {True, False}  # the cases reach both sides of the gate


def test_overlapped_tiles_match_serial(monkeypatch):
    """split_ratio 2 on the CPU: the double-buffered encode (three tiles
    uploaded aside) gives the serial encode's stream byte for byte; each
    tile's train_time is an exclusive window (they sum to no more than the
    wall clock)."""
    img = synth_scene(64, 72, channels=4, effective_bits=12, seed=3)
    cfg = CodecConfig(K=5, split_ratio=2, base_codec="lpc",
                      train=TrainSpec(epochs=2, batch_size=256, sample_granule=8))
    assert codec.tiles_overlap(img.shape, int(img.max()), 2, cfg)
    aside = []
    real = codec._upload_tile_aside

    def counted(*a):
        aside.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(codec, "_upload_tile_aside", counted)
    stream, stats = codec.encode_image(img, cfg, device="cpu")
    assert len(aside) == 3 and len(stats.tiles) == 4
    assert sum(t.train_time for t in stats.tiles) <= stats.elapsed
    assert all(t.train_time > 0 for t in stats.tiles)

    monkeypatch.setattr(codec, "OVERLAP_BUDGET_BYTES", 0)
    assert not codec.tiles_overlap(img.shape, int(img.max()), 2, cfg)
    serial, _ = codec.encode_image(img, cfg, device="cpu")
    assert len(aside) == 3  # the serial order uploads nothing aside
    assert stream == serial
    rec, _ = codec.decode_stream(stream, device="cpu")
    assert (rec >> 5 == img >> 5).all()
