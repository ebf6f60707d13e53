"""The whole GF-2 scene's staging at a CPU size.

A GF-2 PMS scene (7605x7815x4, K 5, granule 8) is over the staging
budget as an f32 feature cache and under it as the "full" int8 tap
matrix, and its 7815 columns are no multiple of 8.  Here a 37x45x4 scene
meets the same two conditions with the budget shrunk between the two
estimates: it picks "full", trains bit for bit as the "cached" fit of
the same seed (the two modes share the flat granule grid, whose last
granule is part padding), decodes with its MSBs exact, and agrees with
the benchmark's plain PyTorch reference decode of the same stream.

Tolerances: the two fits and their streams are compared exactly (every
mode feeds the step values bit-identical to the feature cache's); the
reference decode may differ from the program's in a share of sub-pixels
up to the benchmark cells' `flip_share` limit, read from
`benchmark/limits/gf2.encode.json` (the two forwards sum in different
orders, so a prediction on a rounding edge may land on either side).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from lbdrn_msic_tpu_torch import codec
from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
K = 5
H, W, C = 37, 45, 4


def _reference(name):
    """benchmark/reference/<name>.py, loaded by path (it imports numpy and
    torch only)."""
    spec = importlib.util.spec_from_file_location(
        "gf2_reference_" + name, os.path.join(BENCH, "reference", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def encodes():
    """(scene, cfg, {staging: (stream, stats)}) of one seed, "cached" at
    the card's budget and "full" at one between the two estimates."""
    scene = synth_scene(H, W, channels=C, effective_bits=12, seed=22)
    cfg = CodecConfig(K=K, base_codec="jp2",
                      train=TrainSpec(epochs=3, batch_size=512, sample_granule=8))
    cache = codec._cached_bytes(H, W, C, cfg.features, 8)
    full, _ = codec._staging_bytes(H, W, C, cfg.features, 8, 1, 1)
    assert full < cache - 1
    out = {"cached": codec.encode_image(scene, cfg, device="cpu", collect_curves=True)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(codec, "STAGE_BUDGET_BYTES", cache - 1)
        assert codec.pick_staging(H, W, C, int(scene.max()) >> K, cfg.features,
                                  cfg.train) == ("full", torch.int8)
        out["full"] = codec.encode_image(scene, cfg, device="cpu", collect_curves=True)
    return scene, cfg, out


def test_full_trains_as_cached(encodes):
    _, _, out = encodes
    (s_full, st_full), (s_cached, st_cached) = out["full"], out["cached"]
    assert (st_full.tiles[0].staging, st_cached.tiles[0].staging) == ("full", "cached")
    # int8 taps, a byte each, over the grid's whole granules (the last one part padding)
    assert st_full.tiles[0].staged_bytes == -(-H * W // 8) * 8 * C * 25
    assert np.array_equal(st_full.tiles[0].step_losses, st_cached.tiles[0].step_losses)
    assert st_full.tiles[0].best_mse == st_cached.tiles[0].best_mse
    assert st_full.tiles[0].best_epoch == st_cached.tiles[0].best_epoch
    assert s_full == s_cached


def test_full_decodes_as_the_plain_reference(encodes):
    scene, cfg, out = encodes
    stream = out["full"][0]
    got = codec.decode_stream(stream, device="cpu")[0]
    assert np.array_equal(got >> K, scene >> K)
    plain, reader = _reference("plain"), _reference("stream")
    header = reader.parse_header(stream)
    dims = plain.feature_dims(C, cfg.features.D, cfg.model.base_channel, cfg.model.num_layers)
    layers = plain.layers_from_flat(reader.lfpz_decode(reader.tile_weights(stream, header)[0]),
                                    dims, torch.device("cpu"))
    plane = plain.BasePlane(scene, K, cfg.features.D, torch.device("cpu"))
    ref = plain.reconstruct(plane, layers, cfg.features.relative)
    with open(os.path.join(BENCH, "limits", "gf2.encode.json")) as f:
        limit = json.load(f)["flip_share"]
    assert np.mean(ref != got) <= limit
