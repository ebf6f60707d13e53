"""The port's pipelined paths vs the JAX package's: `encode_pipelined`,
`decode_pipelined(_iter)` with its decode-ahead gate, the streamed decode of
row-chunked `lpc` bases (`dispatch_streamed_lpc`) and the one-call
`reconstruct`.

Tolerances: within the port, bit for bit (streams byte-identical to
`encode_image`, images to `decode_stream`'s and the plain path's); across
the packages, MSBs exact and residuals within +-1 on at most 0.1 % of the
samples (CPU `sin` of the two libraries differs in the last bit).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from lbdrn_msic_tpu import codec as jcodec
from lbdrn_msic_tpu.core.config import FeatureSpec as JFeatureSpec
from lbdrn_msic_tpu.core.config import ModelSpec as JModelSpec
from lbdrn_msic_tpu.decode import reconstruct as jrec
from lbdrn_msic_tpu.models.siren import init_params as jinit
from lbdrn_msic_tpu_torch import codec
from lbdrn_msic_tpu_torch.codecs import base_layer
from lbdrn_msic_tpu_torch.core.config import CodecConfig, FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.decode import reconstruct as rec
from lbdrn_msic_tpu_torch.io.header import decode_header, header_size
from lbdrn_msic_tpu_torch.models.siren import params_from_numpy
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_native import ensure_jax_native  # noqa: E402

ensure_jax_native()  # the reference's native library: once per worker, under a lock

CPU = torch.device("cpu")


def _cfg(K, epochs=2, **kw):
    return CodecConfig(K=K, base_codec="lpc", train=TrainSpec(epochs=epochs, batch_size=1024),
                       **kw)


def test_encode_pipelined_byte_identical_to_encode_image():
    """tests/test_e2e.py:112: each pipelined stream is `encode_image`'s at
    the job's seed: cfg.train.seed by default, `job_seed(seed, i)` for an
    explicit seed, `seeds[i]` when given; a tiled job goes to
    `encode_image`."""
    imgs = [synth_scene(48, 48, channels=2, seed=s) for s in (1, 2, 3)]
    cfgs = [_cfg(4), _cfg(6), _cfg(5, split_ratio=2)]
    jobs = list(zip(imgs, cfgs))
    for kw, seed_of in (({}, lambda i, c: c.train.seed),
                        ({"seed": 7}, lambda i, c: codec.job_seed(7, i)),
                        ({"seeds": [3, 4, 5]}, lambda i, c: 3 + i)):
        piped = codec.encode_pipelined(jobs, device="cpu", **kw)
        for i, ((img, cfg), (stream, stats)) in enumerate(zip(jobs, piped)):
            solo, solo_stats = codec.encode_image(img, cfg, seed=seed_of(i, cfg), device="cpu")
            assert stream == solo, (kw, i)
            assert stats.tiles[0].best_mse == solo_stats.tiles[0].best_mse
            assert stats.total_bytes == len(stream) and stats.n_subpixels == img.size
    rec0, _ = codec.decode_stream(piped[0][0], device="cpu")
    assert np.array_equal(rec0 >> 4, imgs[0] >> 4)


def test_encode_pipelined_bucket_and_header_version():
    img = synth_scene(90, 100, channels=2, seed=13)
    jobs = [(img, _cfg(5)), (img[:, :70], _cfg(3))]
    for kw in ({"bucket": True}, {"header_version": 0}):
        piped = codec.encode_pipelined(jobs, device="cpu", **kw)
        for (im, cfg), (stream, _) in zip(jobs, piped):
            assert stream == codec.encode_image(im, cfg, device="cpu", **kw)[0], kw


@pytest.fixture(scope="module")
def streams():
    """Three small streams at different K (tests/test_e2e.py:273)."""
    imgs = [synth_scene(48, 40, channels=2, seed=s) for s in (90, 91, 92)]
    return [(im, K, codec.encode_image(im, _cfg(K), device="cpu")[0])
            for im, K in zip(imgs, (3, 5, 4))]


def test_decode_pipelined_matches_decode_stream(streams):
    piped = codec.decode_pipelined([s for _, _, s in streams], device="cpu")
    assert len(piped) == 3
    for (im, K, s), (img, dst) in zip(streams, piped):
        np.testing.assert_array_equal(img, codec.decode_stream(s, device="cpu")[0])
        np.testing.assert_array_equal(img >> K, im >> K)
        assert dst.header.K == K


def test_decode_pipelined_ahead_and_memory_gate(streams, monkeypatch):
    """tests/test_e2e.py:292: a deep `ahead` and a byte gate forced shut
    both keep the order and the bits of per-stream decodes."""
    data = [s for _, _, s in streams] * 2
    solos = [codec.decode_stream(s, device="cpu")[0] for s in data]
    out = list(codec.decode_pipelined_iter(iter(data), ahead=5, device="cpu"))
    assert len(out) == 6
    for solo, (img, _) in zip(solos, out):
        np.testing.assert_array_equal(img, solo)
    monkeypatch.setattr(codec, "DECODE_AHEAD_BYTES", 1)
    out = list(codec.decode_pipelined_iter(iter(data), ahead=3, device="cpu"))
    assert len(out) == 6
    for solo, (img, _) in zip(solos, out):
        np.testing.assert_array_equal(img, solo)
    # a mesh whose "dp" axis is 1 keeps the single-card decode (the row-band
    # decode over ranks: tests/test_torch_mesh.py)
    one_rank = type("OneRankMesh", (), {"size": lambda self, dim: 1})()
    out = list(codec.decode_pipelined_iter(iter(data), mesh=one_rank, device="cpu"))
    for solo, (img, _) in zip(solos, out):
        np.testing.assert_array_equal(img, solo)


@pytest.fixture(scope="module")
def lpc_v2():
    """A row-chunked (v2) lpc stream: 1800 rows (4 chunks of 512, the
    last short), K=2 keeps a 10-bit MSB (uint16 bands)."""
    img = synth_scene(1800, 96, channels=2, effective_bits=12, seed=55)
    cfg = CodecConfig(K=2, base_codec="lpc", train=TrainSpec(epochs=1, batch_size=8192))
    return img, codec.encode_image(img, cfg, device="cpu")[0]


def test_lpc_streamed_decode_bit_identical(lpc_v2, monkeypatch):
    """tests/test_e2e.py:316: a v2 lpc stream decodes through
    `dispatch_streamed_lpc` (phase "dispatch_pipelined") to the image the
    plain path gives, bit for bit; also through `decode_pipelined`; and
    the JAX package decodes it to the same MSBs."""
    img, stream = lpc_v2
    hdr = decode_header(stream)
    ptr = header_size(stream) + hdr.nn_bytes[0]
    from lbdrn_msic_tpu_torch.codecs import lpc

    assert lpc.chunk_info(stream[ptr : ptr + hdr.base_bytes[0]])[5] == 4
    rec_pipe, st = codec.decode_stream(stream, device="cpu")
    assert "dispatch_pipelined" in st.phases and "base_decode" not in st.phases, st.phases
    (rec_iter, st_iter), = codec.decode_pipelined([stream], device="cpu")
    assert "dispatch_pipelined" in st_iter.phases
    theirs, _ = jcodec.decode_stream(stream)
    monkeypatch.setattr(rec, "dispatch_streamed_lpc", lambda *a, **k: None)
    rec_plain, st2 = codec.decode_stream(stream, device="cpu")
    assert "base_decode" in st2.phases, st2.phases
    np.testing.assert_array_equal(rec_pipe, rec_plain)
    np.testing.assert_array_equal(rec_iter, rec_plain)
    np.testing.assert_array_equal(rec_pipe >> 2, img >> 2)
    np.testing.assert_array_equal(theirs >> 2, img >> 2)
    diff = theirs.astype(np.int32) - rec_pipe.astype(np.int32)
    assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= 1e-3 * diff.size


def test_lpc_streamed_decode_tiled_bit_identical(monkeypatch):
    """Every tile of a tiled (split_ratio 2) stream with row-chunked lpc
    bases takes the streamed path, as in the JAX package's decode without a
    mesh (its `sp` is the mesh's width), bit for bit the plain path; the JAX
    package decodes it to the same MSBs.  Chunks of 16 rows keep it small."""
    monkeypatch.setattr(base_layer, "LPC_CHUNK_ROWS", 16)
    monkeypatch.setattr(base_layer, "LPC_CHUNK_MIN_H", 32)
    img = synth_scene(96, 64, channels=2, effective_bits=12, seed=78)
    stream, _ = codec.encode_image(img, _cfg(4, epochs=1, split_ratio=2), device="cpu")
    assert decode_header(stream).n_tiles == 4
    rec_pipe, st = codec.decode_stream(stream, device="cpu")
    assert "dispatch_pipelined" in st.phases and "base_decode" not in st.phases, st.phases
    theirs, _ = jcodec.decode_stream(stream)
    monkeypatch.setattr(rec, "dispatch_streamed_lpc", lambda *a, **k: None)
    rec_plain, st2 = codec.decode_stream(stream, device="cpu")
    assert "base_decode" in st2.phases, st2.phases
    np.testing.assert_array_equal(rec_pipe, rec_plain)
    np.testing.assert_array_equal(rec_pipe >> 4, img >> 4)
    np.testing.assert_array_equal(theirs >> 4, img >> 4)


def test_lpc_undersized_chunks_take_plain_path(monkeypatch):
    """tests/test_e2e.py:349: chunks shorter than D cannot hold a band's
    halo, so `dispatch_streamed_lpc` declines and the plain path decodes."""
    monkeypatch.setattr(base_layer, "LPC_CHUNK_ROWS", 1)  # < D = 2
    monkeypatch.setattr(base_layer, "LPC_CHUNK_MIN_H", 1)
    img = synth_scene(64, 48, channels=2, effective_bits=12, seed=77)
    stream, _ = codec.encode_image(img, _cfg(4, epochs=1), device="cpu")
    hdr = decode_header(stream)
    ptr = header_size(stream) + hdr.nn_bytes[0]
    base_stream = stream[ptr : ptr + hdr.base_bytes[0]]
    assert rec.dispatch_streamed_lpc(base_stream, None, FeatureSpec(), hdr.model_spec(), 4,
                                     CPU) is None
    out, st = codec.decode_stream(stream, device="cpu")
    assert "base_decode" in st.phases, st.phases
    np.testing.assert_array_equal(out >> 4, img >> 4)


@pytest.mark.parametrize("K", [3, 5, 10])
def test_reconstruct_matches_streamed_and_jax(K):
    """tests/test_e2e.py:131: the one-call `reconstruct` is the banded
    `reconstruct_streamed` bit for bit (odd W: a padded last octet; 700
    rows: a clamped last block), and within the cross-package tolerance
    of the JAX `reconstruct` from the same params."""
    fspec, mspec = FeatureSpec(), ModelSpec(base_channel=32, num_layers=1)
    img = synth_scene(700, 97, channels=3, seed=55)
    base = (img >> K).astype(np.uint16)
    jp = jinit(jax.random.PRNGKey(1), fspec.feature_dim(3), 3, JModelSpec(32, 1))
    params = params_from_numpy([np.asarray(w) for w in jp.weights],
                               [np.asarray(b) for b in jp.biases])
    one = rec.reconstruct_np(base, params, fspec, mspec, K, CPU)
    streamed = rec.reconstruct_streamed(base, params, fspec, mspec, K, CPU, n_bands=3)
    np.testing.assert_array_equal(streamed, one)
    theirs = jrec.reconstruct_np(base, jp, JFeatureSpec(), JModelSpec(32, 1), K)
    np.testing.assert_array_equal(theirs >> K, one >> K)
    diff = theirs.astype(np.int32) - one.astype(np.int32)
    assert np.abs(diff).max() <= 1 and np.count_nonzero(diff) <= 1e-3 * diff.size


def test_reconstruct_with_coords_matches_streamed():
    """Coordinate features: `reconstruct` is the full-plane streamed path
    bit for bit."""
    fspec = FeatureSpec(use_coords=True, embedding=True)
    mspec = ModelSpec(base_channel=32, num_layers=1)
    img = synth_scene(300, 41, channels=2, seed=56)
    base = (img >> 4).astype(np.uint16)
    jp = jinit(jax.random.PRNGKey(2), fspec.feature_dim(2), 2, JModelSpec(32, 1))
    params = params_from_numpy([np.asarray(w) for w in jp.weights],
                               [np.asarray(b) for b in jp.biases])
    np.testing.assert_array_equal(
        rec.reconstruct_np(base, params, fspec, mspec, 4, CPU),
        rec.reconstruct_streamed(base, params, fspec, mspec, 4, CPU, n_bands=2))
