"""Port feature/label engine vs the JAX package's: bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbdrn_msic_tpu.core.config import FeatureSpec as JFeatureSpec
from lbdrn_msic_tpu.features import engine as jeng
from lbdrn_msic_tpu_torch.core.config import FeatureSpec
from lbdrn_msic_tpu_torch.features import engine
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

H, W, K = 37, 45, 5  # odd on both axes


def _img(C):
    return synth_scene(H, W, channels=C, effective_bits=12, seed=C)


def _both(img, D):
    jmsb, jlsb = jeng.split_msb_lsb(jnp.asarray(img), K)
    jplane, jscale = jeng.pad_plane(jmsb, D)
    msb, lsb = engine.split_msb_lsb(torch.from_numpy(img.astype(np.int32)), K)
    plane, scale = engine.pad_plane(msb, D)
    return (jplane, jscale, jlsb), (plane, scale, lsb)


def _bits(a):
    return np.asarray(a).astype(np.float32).view(np.uint32)


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("D", [0, 1, 2])
def test_split_and_pad_identical(C, D):
    img = _img(C)
    (jplane, jscale, jlsb), (plane, scale, lsb) = _both(img, D)
    np.testing.assert_array_equal(plane.numpy(), np.asarray(jplane).astype(np.int32))
    np.testing.assert_array_equal(lsb.numpy(), np.asarray(jlsb).astype(np.int32))
    assert scale.dtype == torch.float32
    assert _bits(scale.numpy()) == _bits(jscale)
    assert engine.lsb_scale(K) == jeng.lsb_scale(K)


@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("D", [0, 1, 2])
def test_row_block_features_identical(C, D, relative):
    img = _img(C)
    (jplane, jscale, _), (plane, scale, _) = _both(img, D)
    jspec = JFeatureSpec(D=D, relative=relative)
    spec = FeatureSpec(D=D, relative=relative)
    for r0, R in ((0, 7), (H - 11, 11)):
        ref = jeng.row_block_features(jplane, jscale, jnp.int32(r0), jspec, H, W, R)
        got = engine.row_block_features(plane, scale, r0, spec, H, W, R)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("D", [0, 1, 2])
def test_feature_cache_identical(C, D, g):
    img = _img(C)
    (jplane, jscale, _), (plane, scale, _) = _both(img, D)
    jspec, spec = JFeatureSpec(D=D), FeatureSpec(D=D)
    padded_in = 128
    ref = jeng.build_feature_cache(jplane, jscale, jspec, H, W, padded_in, g=g)
    got = engine.build_feature_cache(plane, scale, spec, H, W, padded_in, g=g)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("C", [1, 4])
def test_labels_identical(C, g):
    img = _img(C)
    (_, _, jlsb), (_, _, lsb) = _both(img, 2)
    ref = np.asarray(jeng.build_granule_labels(jlsb, H, W, g))
    got = engine.build_granule_labels(lsb, H, W, g)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))
    # per-pixel gather: the port's direct (n, C) rows == the JAX 8-pixel store
    store = jeng.build_granule_labels(jlsb, H, W, jeng.LABEL_STORE_G)
    idx = np.random.default_rng(0).integers(0, H * W, 500).astype(np.int32)
    jrows = np.asarray(jeng.gather_pixel_labels(store, jnp.asarray(idx), C))
    rows = engine.build_label_matrix(lsb)[torch.from_numpy(idx).long()]
    np.testing.assert_array_equal(rows.numpy(), jrows.astype(np.int32))


# (K, relative) -> the tap dtype of a 12-bit scene's MSB plane: int8, int16,
# absolute uint8, and absolute above 255 (JAX uint16, held as int32 here)
TAP_CASES = [(5, True, "int8", torch.int8), (3, True, "int16", torch.int16),
             (5, False, "uint8", torch.uint8), (3, False, "uint16", torch.int32)]


@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("K_,relative,jdtype,dtype", TAP_CASES)
def test_tap_matrix_identical(K_, relative, jdtype, dtype, g):
    """`build_tap_matrix` holds the JAX package's values for every tap
    dtype and granule; `staged_features` rows are bit-identical to the JAX
    function's and to the port's own feature cache."""
    img = _img(4)
    jmsb, _ = jeng.split_msb_lsb(jnp.asarray(img), K_)
    jplane, jscale = jeng.pad_plane(jmsb, 2)
    msb, _ = engine.split_msb_lsb(torch.from_numpy(img.astype(np.int32)), K_)
    plane, scale = engine.pad_plane(msb, 2)
    mx = int(img.max()) >> K_
    assert jnp.dtype(jeng.tap_matrix_dtype(mx, relative)).name == jdtype
    assert engine.tap_matrix_dtype(mx, relative) == dtype
    jspec, spec = JFeatureSpec(relative=relative), FeatureSpec(relative=relative)
    ref = jeng.build_tap_matrix(jplane, jspec, H, W, jnp.dtype(jdtype), g=g)
    got = engine.build_tap_matrix(plane, spec, H, W, dtype, g=g)
    assert got.dtype == dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(ref).astype(np.int64))

    idx = np.random.default_rng(g).integers(0, got.shape[0], 300)
    jrows = jeng.staged_features(ref, jscale, jnp.asarray(idx), jspec, H, W)
    rows = engine.staged_features(got, scale, torch.from_numpy(idx))
    np.testing.assert_array_equal(_bits(rows.numpy()), _bits(jrows))
    F = rows.shape[1] // g
    cache = engine.build_feature_cache(plane, scale, spec, H, W, 128, g=g)
    np.testing.assert_array_equal(
        _bits(rows.numpy()), _bits(cache.view(-1, g * 128)[idx].view(-1, g, 128)[..., :F]
                                   .reshape(len(idx), -1).numpy()))
    # written into the first F columns of a padded batch buffer
    buf = torch.zeros((len(idx) * g, 128))
    engine.staged_features(got, scale, torch.from_numpy(idx), out=buf[:, :F])
    np.testing.assert_array_equal(_bits(buf.numpy()),
                                  _bits(cache.view(-1, g * 128)[idx].reshape(-1, 128).numpy()))


def test_reflect_index_matches_numpy():
    for n, D in ((5, 2), (9, 4), (37, 1)):
        a = np.arange(n)
        np.testing.assert_array_equal(
            engine.reflect_index(n, D).numpy(), np.pad(a, D, mode="reflect"))
    with pytest.raises(ValueError):
        engine.reflect_index(2, 2)
