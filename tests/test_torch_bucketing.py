"""Shape-bucketed training in the port vs the JAX package: `bucket_dims`
and `_pad_to_bucket` exactly, `fit(hw=)` in every staging mode against the
JAX `fit(hw=)` (the JAX init and permutations injected; epoch losses and
best MSE rtol 1e-5, best epoch exact: the tiers of
tests/test_torch_staging.py), the bucketed eval's normalizer, and
`encode_image(bucket=True)`: within 0.1 dB of the exact-shape encode, the
identity on aligned shapes, and a warned no-op with coordinates (the
counterparts of tests/test_bucketing.py:189-250)."""

import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lbdrn_msic_tpu import codec as jcodec
from lbdrn_msic_tpu.core.config import FeatureSpec as JFeatureSpec
from lbdrn_msic_tpu.core.config import ModelSpec as JModelSpec
from lbdrn_msic_tpu.core.config import TrainSpec as JTrainSpec
from lbdrn_msic_tpu.features import engine as jeng
from lbdrn_msic_tpu.models.siren import init_params as jinit
from lbdrn_msic_tpu.train import loop as jloop
from lbdrn_msic_tpu_torch import codec
from lbdrn_msic_tpu_torch.core.config import CodecConfig, FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.eval.metrics import psnr
from lbdrn_msic_tpu_torch.features import engine
from lbdrn_msic_tpu_torch.models.siren import forward, params_from_numpy
from lbdrn_msic_tpu_torch.train import loop
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_native import ensure_jax_native  # noqa: E402

ensure_jax_native()  # the reference's native library: once per worker, under a lock

K = 5
# the bench scene, small tiles, edges of both quanta, the reference scenes
# (GF-2 7340/7605x7815, GF-6 6000^2) and dimensions within D of a step
BUCKET_SHAPES = [(2048, 2048), (90, 100), (120, 110), (127, 127), (128, 128), (129, 1),
                 (1023, 1024), (1024, 1025), (1025, 1536), (7340, 7815), (7605, 7815),
                 (6000, 6000), (126, 254), (1022, 1535), (1535, 2047), (3070, 511)]


@pytest.mark.parametrize("D", [0, 1, 2, 3])
def test_bucket_dims_match_jax(D):
    assert (codec.BUCKET_SMALL_Q, codec.BUCKET_LARGE_Q) == (jcodec.BUCKET_SMALL_Q,
                                                            jcodec.BUCKET_LARGE_Q)
    for H, W in BUCKET_SHAPES:
        assert codec.bucket_dims(H, W, D) == jcodec.bucket_dims(H, W, D), (H, W, D)
    assert codec.bucket_dims(7340, 7815) == codec.bucket_dims(7605, 7815) == (7680, 8192)


@pytest.mark.parametrize("shape,D", [((2, 90, 100), 2), ((3, 21, 35), 2), ((1, 126, 3), 1),
                                     ((4, 5, 7), 3), ((2, 128, 120), 2)])
def test_pad_to_bucket_matches_jax(shape, D):
    img = np.random.default_rng(sum(shape)).integers(0, 4096, shape).astype(np.uint16)
    _, H, W = shape
    for Hb, Wb in (codec.bucket_dims(H, W, D), (H + D + 3, W + D), (H, W + 1)):
        got = codec._pad_to_bucket(img, D, Hb, Wb)
        np.testing.assert_array_equal(got, jcodec._pad_to_bucket(img, D, Hb, Wb))
        np.testing.assert_array_equal(got[:, :H, :W], img)
        assert got.max() == img.max()


def _bucket_planes(H, W, Hb, Wb, C, D=2, seed=3):
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=seed)
    padded = codec._pad_to_bucket(img, D, Hb, Wb)
    jmsb, jlsb = jeng.split_msb_lsb(jnp.asarray(padded), K)
    jplane, jscale = jeng.pad_plane(jmsb, D)
    msb, lsb = engine.split_msb_lsb(torch.from_numpy(padded.astype(np.int32)), K)
    plane, scale = engine.pad_plane(msb, D)
    return img, (jplane, jscale, jlsb.astype(jnp.uint16)), (plane, scale, lsb)


def _jax_draws(key, n_g, C, epochs):
    key, ik = jax.random.split(key)
    jp = jinit(ik, 100, C, JModelSpec(), pad_input_to=128)
    perms = []
    for _ in range(epochs):
        key, pk = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(pk, n_g)))
    return params_from_numpy([np.asarray(w) for w in jp.weights],
                             [np.asarray(b) for b in jp.biases]), perms


JAX_TAP_DTYPE = {"cached": "float32", "full": "int8", "banded": "uint8", "gather": "int16"}


@pytest.mark.parametrize("staging", ["cached", "full", "banded", "gather"])
def test_fit_hw_matches_jax(staging):
    """A 21x35x4 tile padded to 24x40 (35 % 8 != 0: granules straddle the
    real edge), bs 256, g=8, e=3: `fit(hw=(21, 35))` vs the JAX
    `fit(hw=)` in interpret mode, the JAX init and permutations
    injected."""
    H, W, Hb, Wb, C, e = 21, 35, 24, 40, 4, 3
    _, (jplane, jscale, jlsb), (plane, scale, lsb) = _bucket_planes(H, W, Hb, Wb, C)
    jt = JTrainSpec(batch_size=256, epochs=e, sample_granule=8)
    t = TrainSpec(batch_size=256, epochs=e, sample_granule=8)
    ls = np.float32(jeng.lsb_scale(K))
    key = jax.random.PRNGKey(11)
    with pltpu.force_tpu_interpret_mode():
        ref = jloop.fit(jplane, jscale, jlsb, ls, key, JFeatureSpec(), JModelSpec(), jt, Hb, Wb,
                        C, staging=staging, tap_dtype=JAX_TAP_DTYPE[staging], use_fused=True,
                        hw=jnp.asarray([H, W], jnp.int32))
    geo = loop._batch_geometry(t, Hb, Wb, staging)
    init, perms = _jax_draws(key, geo.n_g, C, e)
    got = loop.fit(plane, scale, lsb, float(ls), None, FeatureSpec(), ModelSpec(), t, Hb, Wb, C,
                   staging=staging, use_fused=True, init=init, perms=perms, hw=(H, W),
                   device="cpu")
    assert got.step_losses.shape == ref.step_losses.shape
    np.testing.assert_allclose(got.epoch_losses.numpy(), np.asarray(ref.epoch_losses), rtol=1e-5)
    assert got.best_epoch == int(ref.best_epoch)
    np.testing.assert_allclose(got.best_mse, float(ref.best_mse), rtol=1e-5)


def test_bucketed_eval_normalizes_by_real_pixels():
    """`blocks_mse(hw=)` is the MSE over the real tile only: the SSE of
    pixels at row < hw[0] and column < hw[1] over hw[0] * hw[1] * C, not
    the bucket's pixel count; and the masks leave every pad pixel out."""
    H, W, Hb, Wb, C = 21, 35, 24, 40, 4
    _, _, (plane, scale, lsb) = _bucket_planes(H, W, Hb, Wb, C)
    params, _ = _jax_draws(jax.random.PRNGKey(2), 1, C, 0)
    spec, mspec = FeatureSpec(), ModelSpec()
    x = engine.row_block_features(plane, scale, 0, spec, Hb, Wb, Hb)
    x = torch.nn.functional.pad(x, (0, 128 - x.shape[1]))
    y = engine.build_label_matrix(lsb).to(torch.float32) * engine.lsb_scale(K)
    err = ((forward(params, x, mspec) - y) ** 2).view(Hb, Wb, C)
    want = float(err[:H, :W].sum()) / (H * W * C)
    for R in (5, 8, Hb):
        got = float(loop.blocks_mse(params, lambda r0: x[r0 * Wb : (r0 + R) * Wb],
                                    lambda r0: y[r0 * Wb : (r0 + R) * Wb], mspec, Hb, Wb, C, R,
                                    hw=(H, W)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    geo = loop._batch_geometry(TrainSpec(batch_size=256, sample_granule=8), Hb, Wb)
    gi, masks = loop._epoch_batches(0, None, torch.Generator().manual_seed(0), geo, Hb, Wb,
                                    torch.device("cpu"), hw=(H, W))
    pix = (gi[:, :, None] * 8 + torch.arange(8)).reshape(masks.shape)
    real = (pix // Wb < H) & (pix % Wb < W)
    assert torch.equal(masks.bool(), real) and int(masks.sum()) == H * W


def _cfg(epochs=2, **features):
    return CodecConfig(K=K, base_codec="lpc", features=FeatureSpec(**features),
                       train=TrainSpec(epochs=epochs, batch_size=2048))


def test_bucketed_encode_rd_close_to_exact():
    """A 90x100x2 scene (bucket 128x128): the bucketed encode lands within
    0.1 dB of the exact-shape one, decodes at the real shape with MSBs
    exact, and its stream is no larger by more than a few bytes."""
    img = synth_scene(90, 100, channels=2, seed=13)
    cfg = _cfg(epochs=4)
    se, _ = codec.encode_image(img, cfg, device="cpu")
    sb, _ = codec.encode_image(img, cfg, bucket=True, device="cpu")
    assert sb != se
    re_, rb = (codec.decode_stream(s, device="cpu")[0] for s in (se, sb))
    assert rb.shape == img.shape and np.array_equal(rb >> K, img >> K)
    assert abs(psnr(img, re_) - psnr(img, rb)) < 0.1, (psnr(img, re_), psnr(img, rb))
    assert abs(len(sb) - len(se)) < 64


def test_bucket_noop_for_aligned_shapes():
    img = synth_scene(128, 128, channels=2, seed=14)
    cfg = _cfg()
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # quiet for colour features
        s1, _ = codec.encode_image(img, cfg, bucket=True, device="cpu")
    assert s1 == codec.encode_image(img, cfg, device="cpu")[0]


def test_bucket_skipped_for_coords_features():
    """Coordinates are normalized by the shape, so bucketing falls back to
    the exact shape (the same stream) and says so with a RuntimeWarning;
    colour features bucket without it."""
    img = synth_scene(90, 100, channels=2, seed=15)
    cfg = _cfg(use_coords=True)
    s0, _ = codec.encode_image(img, cfg, device="cpu")
    with pytest.warns(RuntimeWarning, match="bucket=True requested"):
        s1, _ = codec.encode_image(img, cfg, bucket=True, device="cpu")
    assert s0 == s1
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        codec.encode_image(img, _cfg(), bucket=True, device="cpu")
