"""Port codec vs the JAX package's: headers byte-identical, streams
cross-decode both ways, port streams deterministic."""

import struct
import warnings

import numpy as np
import pytest
import torch

from lbdrn_msic_tpu import codec as jcodec
from lbdrn_msic_tpu.core.config import CodecConfig as JCodecConfig
from lbdrn_msic_tpu.core.config import FeatureSpec as JFeatureSpec
from lbdrn_msic_tpu.core.config import ModelSpec as JModelSpec
from lbdrn_msic_tpu.core.config import TrainSpec as JTrainSpec
from lbdrn_msic_tpu.io import header as jheader
from lbdrn_msic_tpu_torch import codec
from lbdrn_msic_tpu_torch.core.config import CodecConfig, FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.eval.metrics import psnr
from lbdrn_msic_tpu_torch.io import header
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

K = 5


def _cfgs(base="lpc", sr=1, **kw):
    t = dict(epochs=2, batch_size=512, sample_granule=8)
    return (CodecConfig(K=K, base_codec=base, split_ratio=sr, train=TrainSpec(**t), **kw),
            JCodecConfig(K=K, base_codec=base, split_ratio=sr, train=JTrainSpec(**t)))


@pytest.fixture(scope="module")
def scene():
    return synth_scene(64, 64, channels=4, effective_bits=12, seed=21)


@pytest.mark.parametrize(
    "K_,bc,nl,D,sr,base",
    [(5, 64, 2, 2, 1, "jp2"), (3, 32, 1, 1, 2, "lpc"), (10, 128, 3, 0, 3, "lpc")],
)
def test_v1_header_byte_identical(K_, bc, nl, D, sr, base):
    kw = dict(K=K_, split_ratio=sr, base_codec=base)
    cfg = CodecConfig(model=ModelSpec(bc, nl), features=FeatureSpec(D=D), **kw)
    jcfg = JCodecConfig(model=JModelSpec(bc, nl), features=JFeatureSpec(D=D), **kw)
    n = sr * sr
    sizes = ([1000 + i for i in range(n)], [5000 + 7 * i for i in range(n)])
    got = header.encode_header(header.header_from_config(cfg, 640, 480, *sizes, version=1))
    ref = jheader.encode_header(jheader.header_from_config(jcfg, 640, 480, *sizes, version=1))
    assert got == ref
    assert header.decode_header(ref).K == K_


@pytest.mark.parametrize("base,sr", [("lpc", 1), ("jp2", 1), ("lpc", 2)])
def test_port_stream_read_by_jax(scene, base, sr):
    cfg, _ = _cfgs(base, sr)
    stream, stats = codec.encode_image(scene, cfg, device="cpu")
    assert stats.total_bytes == len(stream)
    own, _ = codec.decode_stream(stream, device="cpu")
    theirs, _ = jcodec.decode_stream(stream)
    for rec in (own, theirs):
        assert rec.dtype == np.uint16 and rec.shape == scene.shape
        assert np.array_equal(rec >> K, scene >> K)
    assert abs(psnr(scene, own) - psnr(scene, theirs)) < 0.1


def test_jax_stream_read_by_port(scene):
    _, jcfg = _cfgs("lpc")
    stream, _ = jcodec.encode_image(scene, jcfg)
    theirs, _ = jcodec.decode_stream(stream)
    own, _ = codec.decode_stream(stream, device="cpu")
    assert np.array_equal(own >> K, scene >> K)
    assert np.array_equal(own >> K, theirs >> K)
    # residual = round(pred * (2^K-1)): f32 matmuls summed in another order
    # can land a prediction on the other side of a rounding edge
    diff = own.astype(np.int32) - theirs.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= 1e-3 * diff.size


def test_port_streams_deterministic(scene):
    cfg, _ = _cfgs("lpc")
    a, _ = codec.encode_image(scene, cfg, device="cpu")
    b, _ = codec.encode_image(scene, cfg, device="cpu")
    assert a == b
    c, _ = codec.encode_image(scene, cfg, seed=cfg.train.seed + 1, device="cpu")
    assert c != a


def test_pick_staging_rule():
    fs, ts = FeatureSpec(), TrainSpec(sample_granule=8)
    jfs, jts = JFeatureSpec(), JTrainSpec(sample_granule=8)
    for H, W, C in ((2048, 2048, 4), (4096, 4096, 4), (6000, 6000, 8), (20000, 20000, 8)):
        with warnings.catch_warnings():  # 20000^2 x 8 falls back to gathers
            warnings.simplefilter("ignore", RuntimeWarning)
            got, _ = codec.pick_staging(H, W, C, 127, fs, ts)
        ref, _ = jcodec.pick_staging(H, W, C, 127, jfs, jts, warn=False)
        assert got == ref
    assert codec.pick_staging(2048, 2048, 4, 127, fs, ts) == ("cached", torch.float32)


@pytest.mark.parametrize("c,h,chunk_rows", [(255, 0x7FFFFFFF, 1), (1, 0x7FFFFFFF, 2),
                                            (255, 0x7FFFFFFF, 0x7FFFFFFF)])
def test_lpc_v2_crafted_header_rejected(c, h, chunk_rows):
    """A v2 header whose chunk table (c * ceil(h / chunk_rows) entries)
    overflows 32-bit arithmetic or outruns the stream must fail the parse:
    `decode` and `chunk_info` raise instead of crashing.  A real v2 stream
    still parses."""
    from lbdrn_msic_tpu_torch.codecs import lpc

    head = b"LLPC" + struct.pack("<BBBIIIH", 2, 2, c, h, 16, chunk_rows, 4095)
    bad = head + bytes(64)
    with pytest.raises(ValueError):
        lpc.decode(bad)
    with pytest.raises(ValueError):
        lpc.chunk_info(bad)
    msb = (np.arange(3 * 40 * 24, dtype=np.uint16) % 97).reshape(3, 40, 24)
    good = lpc.encode(msb, chunk_rows=16)
    assert lpc.chunk_info(good) == (3, 40, 24, 2, 16, 3, 96)
    assert np.array_equal(lpc.decode(good), msb)


def test_unported_paths_raise(scene, monkeypatch):
    cfg, _ = _cfgs("lpc")
    # a tile above the feature-cache budget trains on "full" staging: the
    # same network as "cached" (W % 8 == 0), so the same stream
    cached, _ = codec.encode_image(scene, cfg, device="cpu")
    monkeypatch.setattr(codec, "STAGE_BUDGET_BYTES", 64 * 64 * 128 * 4)
    assert codec.pick_staging(64, 64, 4, int(scene.max()) >> K, cfg.features,
                              cfg.train) == ("full", torch.int8)
    full, _ = codec.encode_image(scene, cfg, device="cpu")
    assert full == cached
    assert np.array_equal(codec.decode_stream(full, device="cpu")[0] >> K, scene >> K)
    coords = CodecConfig(K=K, features=FeatureSpec(use_coords=True), train=cfg.train)
    with pytest.raises(NotImplementedError):
        codec.encode_image(scene, coords, device="cpu")
