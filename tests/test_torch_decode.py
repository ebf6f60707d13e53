"""Port decode path vs the JAX package's: bitplanes, band halos, banded
residual dispatch and host assembly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbdrn_msic_tpu.core.config import FeatureSpec as JFeatureSpec
from lbdrn_msic_tpu.core.config import ModelSpec as JModelSpec
from lbdrn_msic_tpu.decode import reconstruct as jrec
from lbdrn_msic_tpu.models.siren import init_params as jinit
from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec
from lbdrn_msic_tpu_torch.decode import reconstruct as rec
from lbdrn_msic_tpu_torch.models.siren import params_from_numpy


@pytest.mark.parametrize("n", [64, 61, 8 * 37 + 3])
def test_pack_bitplanes_identical(n):
    vals = np.random.default_rng(n).integers(0, 1 << 11, n).astype(np.int32)
    ref = np.asarray(jrec._pack_bitplanes(jnp.asarray(vals.astype(np.uint16))))
    got = rec._pack_bitplanes(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(rec._pack_bitplanes(torch.from_numpy(vals), 5).numpy(), ref[:5])


@pytest.mark.parametrize("r0,rows,D", [(0, 8, 2), (5, 8, 1), (12, 8, 2), (0, 20, 0)])
def test_band_halo_and_layout(r0, rows, D):
    base = np.arange(3 * 20 * 6, dtype=np.uint16).reshape(3, 20, 6)
    np.testing.assert_array_equal(rec._band_halo(base, r0, rows, D),
                                  jrec._band_halo(base, r0, rows, D))
    for H in (100, 511, 512, 2048, 7605):
        assert rec._band_layout(H, 8) == jrec._band_layout(H, 8)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_assemble_native_matches_numpy(dtype):
    rng = np.random.default_rng(1)
    K = 5
    base = rng.integers(0, 200, (2, 7, 9)).astype(dtype)
    res = rng.integers(0, 1 << K, base.size).astype(np.int32)
    planes = rec._pack_bitplanes(torch.from_numpy(res), K).numpy()
    got = rec._assemble_band(list(planes), base, K)
    ref = rec._assemble_band_np(list(planes), base, K)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, (base.astype(np.uint16) << K) + res.reshape(base.shape).astype(np.uint16))


def test_banded_decode_matches_jax():
    """Several bands (H >= 512), the last one overlapping its predecessor:
    the port's residuals vs the JAX dispatch_streamed on the same base and
    weights — f32 matmuls in another order may flip a rounding edge."""
    C, H, W, K = 2, 530, 12, 5
    base = np.random.default_rng(2).integers(0, 128, (C, H, W)).astype(np.uint8)
    jspec = JModelSpec(32, 2)
    jp = jinit(jax.random.PRNGKey(3), JFeatureSpec().feature_dim(C), C, jspec)
    p = params_from_numpy([np.asarray(w) for w in jp.weights], [np.asarray(b) for b in jp.biases])
    ref = jrec.dispatch_streamed(base, jp, JFeatureSpec(), jspec, K)()
    got = rec.dispatch_streamed(base, p, FeatureSpec(), ModelSpec(32, 2), K,
                                torch.device("cpu"))()
    assert got.dtype == np.uint16 and got.shape == (C, H, W)
    assert np.array_equal(got >> K, base.astype(np.uint16))
    diff = got.astype(np.int32) - ref.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= 1e-3 * diff.size


def test_coords_decode_not_ported():
    base = np.zeros((1, 8, 8), np.uint8)
    p = params_from_numpy(*[[np.zeros((128, 64), np.float32)], [np.zeros(64, np.float32)]])
    with pytest.raises(NotImplementedError):
        rec.dispatch_streamed(base, p, FeatureSpec(use_coords=True), ModelSpec(), 5,
                              torch.device("cpu"))
