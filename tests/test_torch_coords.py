"""Coordinate features in the port vs the JAX package: the features, the
four batch builders and the feature cache, `fit` in every staging mode
(coordinates only included), `pick_staging` at the budget tie, and
coordinate streams decoded across the packages.

Tolerances:
- `_coord_features` without embedding and every colour column: bit for bit;
  the sin/cos embedding: 1e-6 absolute (CPU `sin`/`cos` of the two
  libraries differ in the last bit);
- coordinate columns of the JAX builders, which are jitted: one f32 ulp at
  |p| <= 1 (2^-23) without embedding, since XLA turns the division by
  (H - 1) into a product with its reciprocal; with it, that ulp times the
  top frequency (pi * sigma^(n_freq - 1)) on top of 1e-6;
- a whole fit vs the JAX fit: epoch losses and best MSE rtol 1e-5, best
  epoch exact (the tiers of tests/test_torch_staging.py);
- cross-decoded streams: MSBs exact, residuals within +-1 on at most 0.1 %
  of the samples (the parity contract of tests/test_torch_experts.py).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lbdrn_msic_tpu import codec as jcodec
from lbdrn_msic_tpu.core.config import CodecConfig as JCodecConfig
from lbdrn_msic_tpu.core.config import FeatureSpec as JFeatureSpec
from lbdrn_msic_tpu.core.config import ModelSpec as JModelSpec
from lbdrn_msic_tpu.core.config import TrainSpec as JTrainSpec
from lbdrn_msic_tpu.decode import reconstruct as jrec
from lbdrn_msic_tpu.features import engine as jeng
from lbdrn_msic_tpu.models.siren import init_params as jinit
from lbdrn_msic_tpu.models.siren import pad_dim
from lbdrn_msic_tpu.train import loop as jloop
from lbdrn_msic_tpu_torch import codec
from lbdrn_msic_tpu_torch.core.config import CodecConfig, FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.decode import reconstruct as rec
from lbdrn_msic_tpu_torch.features import engine
from lbdrn_msic_tpu_torch.models.siren import params_from_numpy
from lbdrn_msic_tpu_torch.train import loop
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_native import ensure_jax_native  # noqa: E402

ensure_jax_native()  # the reference's native library: once per worker, under a lock

K = 5
EMB_ATOL = 1e-6
ULP_ATOL = 2.0**-23
EMB_JIT_ATOL = ULP_ATOL * np.pi * 1.4**11 + EMB_ATOL  # FeatureSpec's sigma, n_freq
# (use_colors, embedding): colours + plain coordinates, colours + embedding,
# coordinates only (embedded)
SPECS = [(True, False), (True, True), (False, True)]


def _specs(use_colors, embedding, D=2):
    kw = dict(use_coords=True, embedding=embedding, use_colors=use_colors, D=D)
    return JFeatureSpec(**kw), FeatureSpec(**kw)


def _close(got, want, spec, jitted=True):
    """Coordinate columns at the tiers above; colour columns bit for bit."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    nc = spec.num_coord_features()
    if spec.embedding or jitted:
        atol = ((EMB_JIT_ATOL if jitted else EMB_ATOL) if spec.embedding else ULP_ATOL)
        np.testing.assert_allclose(got[..., :nc], want[..., :nc], rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(got[..., :nc].view(np.uint32), want[..., :nc].view(np.uint32))
    np.testing.assert_array_equal(got[..., nc:].view(np.uint32), want[..., nc:].view(np.uint32))


@pytest.mark.parametrize("embedding", [False, True])
@pytest.mark.parametrize("H,W", [(24, 37), (2048, 2048), (7605, 7815)])
def test_coord_features_match_jax(H, W, embedding):
    rng = np.random.default_rng(H)
    ii, jj = rng.integers(0, H, 4000), rng.integers(0, W, 4000)
    jspec, spec = _specs(True, embedding)
    want = jeng._coord_features(jnp.asarray(ii), jnp.asarray(jj), H, W, jspec)
    got = engine._coord_features(torch.from_numpy(ii), torch.from_numpy(jj), H, W, spec)
    assert got.dtype == torch.float32 and got.shape[-1] == spec.num_coord_features()
    _close(got.numpy(), want, spec, jitted=False)


def _planes(H, W, C, D, seed=0):
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=seed)
    jmsb, jlsb = jeng.split_msb_lsb(jnp.asarray(img), K)
    jplane, jscale = jeng.pad_plane(jmsb, D)
    msb, lsb = engine.split_msb_lsb(torch.from_numpy(img.astype(np.int32)), K)
    plane, scale = engine.pad_plane(msb, D)
    return (jplane, jscale, jlsb.astype(jnp.uint16)), (plane, scale, lsb)


@pytest.mark.parametrize("use_colors,embedding", SPECS)
def test_builders_match_jax(use_colors, embedding):
    """The slice path, the gather path, the feature cache, the banded
    builder and the staged builder with coordinates against the JAX
    functions (granule coordinates from the pixel index, as JAX's g > 1
    batches compute them)."""
    H, W, C, D, g = 24, 37, 3, 2, 8
    (jplane, jscale, _), (plane, scale, _) = _planes(H, W, C, D)
    jspec, spec = _specs(use_colors, embedding, D)
    F = spec.feature_dim(C)
    assert F == jspec.feature_dim(C)

    want = jeng.row_block_features(jplane, jscale, jnp.int32(5), jspec, H, W, 7)
    _close(engine.row_block_features(plane, scale, 5, spec, H, W, 7).numpy(), want, spec)

    idx = np.random.default_rng(1).integers(0, H * W + 30, 300).astype(np.int32)
    want = jeng.gather_features(jplane, jscale, jnp.asarray(idx), jspec, H, W)
    got = engine.gather_features(plane, scale, torch.from_numpy(idx).long(), spec, H, W)
    _close(got.numpy(), want, spec)
    buf = torch.zeros((len(idx), 256))
    engine.gather_features(plane, scale, torch.from_numpy(idx).long(), spec, H, W, out=buf[:, :F])
    np.testing.assert_array_equal(buf[:, :F].numpy(), got.numpy())
    assert not buf[:, F:].any()

    padded = pad_dim(F)
    want = jeng.build_feature_cache(jplane, jscale, jspec, H, W, padded, g=g)
    _close(engine.build_feature_cache(plane, scale, spec, H, W, padded, g=g).numpy(), want, spec)
    if not use_colors:
        return

    Wg, ng_row = engine.banded_geometry(W, g)
    rt = engine.build_row_taps(plane, spec, H, W, g, torch.int16)
    jrt = jeng.build_row_taps(jplane, jspec, H, W, g, jnp.uint16)
    gidx = np.random.default_rng(2).permutation(H * ng_row)[:60]
    want = jeng.banded_window_features(jrt, jscale, jnp.asarray(gidx), jspec, H, W, g)
    got = engine.banded_window_features(rt, scale, torch.from_numpy(gidx), spec, H, W, g)
    _close(got.numpy(), want, spec)
    buf = torch.zeros((len(gidx) * g, 256))
    engine.banded_window_features(rt, scale, torch.from_numpy(gidx), spec, H, W, g,
                                  out=buf[:, :F])
    np.testing.assert_array_equal(buf[:, :F].numpy(), got.numpy())

    for g_ in (1, g):
        taps = engine.build_tap_matrix(plane, spec, H, W, torch.int8, g=g_)
        jtaps = jeng.build_tap_matrix(jplane, jspec, H, W, jnp.int8, g=1)
        n_g = -(-H * W // g_)
        ids = np.random.default_rng(3).permutation(n_g)[:40]
        pix = (ids[:, None] * g_ + np.arange(g_)).reshape(-1)
        pix = np.minimum(pix, H * W - 1)  # JAX's staged rows are pixel rows
        want = jeng.staged_features(jtaps, jscale, jnp.asarray(pix), jspec, H, W)
        got = engine.staged_features(taps, scale, torch.from_numpy(ids), spec=spec, H=H, W=W,
                                     g=g_)
        _close(got.numpy(), want, spec)
        buf = torch.zeros((len(ids) * g_, 256))
        engine.staged_features(taps, scale, torch.from_numpy(ids), out=buf[:, :F], spec=spec,
                               H=H, W=W, g=g_)
        np.testing.assert_array_equal(buf[:, :F].numpy(), got.numpy())


def _jax_draws(key, n_g, dim_in, C, epochs):
    """The JAX fit's own init params and epoch permutations."""
    key, ik = jax.random.split(key)
    jp = jinit(ik, dim_in, C, JModelSpec(), pad_input_to=pad_dim(dim_in))
    perms = []
    for _ in range(epochs):
        key, pk = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(pk, n_g)))
    return params_from_numpy([np.asarray(w) for w in jp.weights],
                             [np.asarray(b) for b in jp.biases]), perms


FIT_CASES = [("cached", True, True), ("full", True, True), ("banded", True, True),
             ("gather", True, True), ("full", True, False), ("cached", False, True),
             ("gather", False, True)]


@pytest.mark.parametrize("staging,use_colors,use_fused", FIT_CASES)
def test_fit_with_coords_matches_jax(staging, use_colors, use_fused):
    """24x37x4, bs 256, g=8, e=3, coordinates with the embedding:
    `fit(staging=s)` vs the JAX fit (fused step in interpret mode, or the
    exact step), the JAX init and permutations injected.  Coordinates only
    train on "cached" and "gather" in both packages."""
    H, W, C, e = 24, 37, 4, 3
    (jplane, jscale, jlsb), (plane, scale, lsb) = _planes(H, W, C, 2, seed=3)
    jspec, spec = _specs(use_colors, True)
    jt = JTrainSpec(batch_size=256, epochs=e, sample_granule=8)
    t = TrainSpec(batch_size=256, epochs=e, sample_granule=8)
    ls = np.float32(jeng.lsb_scale(K))
    key = jax.random.PRNGKey(11)
    tap = {"cached": "float32", "full": "int8", "banded": "uint8", "gather": "int16"}[staging]

    def run_jax():
        return jloop.fit(jplane, jscale, jlsb, ls, key, jspec, JModelSpec(), jt, H, W, C,
                         staging=staging, tap_dtype=tap, use_fused=use_fused)

    if use_fused:
        with pltpu.force_tpu_interpret_mode():
            ref = run_jax()
    else:
        ref = run_jax()
    geo = loop._batch_geometry(t, H, W, staging)
    init, perms = _jax_draws(key, geo.n_g, spec.feature_dim(C), C, e)
    got = loop.fit(plane, scale, lsb, float(ls), None, spec, ModelSpec(), t, H, W, C,
                   staging=staging, use_fused=use_fused, init=init, perms=perms, device="cpu")
    assert got.step_losses.shape == ref.step_losses.shape
    np.testing.assert_allclose(got.epoch_losses.numpy(), np.asarray(ref.epoch_losses), rtol=1e-5)
    assert got.best_epoch == int(ref.best_epoch)
    np.testing.assert_allclose(got.best_mse, float(ref.best_mse), rtol=1e-5)


def test_coords_fit_staging_rule():
    """Coordinates only: "full" and "banded" fall to "gather"; the granule
    fits of "cached" and "full" with colours agree bit for bit (the batch
    builders give the cache's values)."""
    H, W, C = 24, 40, 4
    _, (plane, scale, lsb) = _planes(H, W, C, 2, seed=3)
    t = TrainSpec(batch_size=256, epochs=2, sample_granule=8)
    _, only = _specs(False, True)
    run = lambda spec, st: loop.fit(plane, scale, lsb, engine.lsb_scale(K),
                                    torch.Generator().manual_seed(1), spec, ModelSpec(), t, H,
                                    W, C, staging=st, device="cpu")
    assert run(only, "full").staging == "gather" and run(only, "banded").staging == "gather"
    _, both = _specs(True, True)
    a, b = run(both, "cached"), run(both, "full")
    assert torch.equal(a.step_losses, b.step_losses) and a.best_mse == b.best_mse


def test_pick_staging_coords_tie_matches_jax(monkeypatch):
    """At the JAX package's budget, 2048^2 x 4 with coordinates + embedding
    and g = 8 has an f32 cache with its grouped copy of exactly 8 GiB, the
    budget: "cached" in both packages (the `<=` rule).  Coordinates only
    above the budget: "gather"."""
    monkeypatch.setattr(codec, "STAGE_BUDGET_BYTES", jcodec.STAGE_BUDGET_BYTES)
    fs, jfs = FeatureSpec(use_coords=True, embedding=True), JFeatureSpec(use_coords=True,
                                                                         embedding=True)
    ts, jts = TrainSpec(sample_granule=8), JTrainSpec(sample_granule=8)
    assert codec._cached_bytes(2048, 2048, 4, fs, 8) == codec.STAGE_BUDGET_BYTES
    assert jcodec._cached_bytes(2048, 2048, 4, jfs, 8) == jcodec.STAGE_BUDGET_BYTES
    cases = [(2048, 2048, 4, fs, jfs), (2048, 2056, 4, fs, jfs), (4096, 4096, 4, fs, jfs)]
    no_col = dict(use_coords=True, embedding=True, use_colors=False)
    cases += [(H, W, 4, FeatureSpec(**no_col), JFeatureSpec(**no_col))
              for H, W in ((2048, 2048), (8192, 8192))]
    for H, W, C, f, jf in cases:
        ref, _ = jcodec.pick_staging(H, W, C, 4095 >> K, jf, jts, warn=False)
        got, _ = codec.pick_staging(H, W, C, 4095 >> K, f, ts)
        assert got == ref, (H, W, f)
    assert codec.pick_staging(2048, 2048, 4, 127, fs, ts)[0] == "cached"


def _flips_ok(a, b):
    diff = a.astype(np.int32) - b.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= 1e-3 * diff.size


@pytest.mark.parametrize("embedding", [False, True])
def test_coords_stream_cross_decodes(embedding):
    """The config of tests/test_e2e.py:70 (64x64x2, K=3, coordinates, D=1,
    bc=32, nl=1, e=2, bs=2048), lpc base: the port's stream decodes in JAX
    and the JAX stream in the port, each against its own package's decode.
    The port's decode takes the full-plane path."""
    img = synth_scene(64, 64, channels=2, seed=13)
    kw = dict(K=3, base_codec="lpc")
    cfg = CodecConfig(features=FeatureSpec(use_coords=True, embedding=embedding, D=1),
                      model=ModelSpec(base_channel=32, num_layers=1),
                      train=TrainSpec(epochs=2, batch_size=2048), **kw)
    jcfg = JCodecConfig(features=JFeatureSpec(use_coords=True, embedding=embedding, D=1),
                        model=JModelSpec(base_channel=32, num_layers=1),
                        train=JTrainSpec(epochs=2, batch_size=2048), **kw)
    ours, _ = codec.encode_image(img, cfg, device="cpu")
    theirs, _ = jcodec.encode_image(img, jcfg)
    for stream in (ours, theirs):
        got, st = codec.decode_stream(stream, device="cpu")
        want, _ = jcodec.decode_stream(stream)
        assert st.header.use_coords and st.header.embedding == embedding
        assert np.array_equal(got >> 3, img >> 3) and np.array_equal(want >> 3, img >> 3)
        _flips_ok(got, want)


def test_full_plane_residuals_match_jax():
    """`_residual_band_planes` (whole base uploaded, global rows) against
    the JAX full-plane function, band by band, with coordinates: 530 rows,
    so two 256-row bands and a clamped last block."""
    C, H, W = 2, 530, 12
    base = np.random.default_rng(2).integers(0, 128, (C, H, W)).astype(np.uint8)
    jspec, spec = _specs(True, True, D=2)
    mj = JModelSpec(32, 2)
    jp = jinit(jax.random.PRNGKey(3), jspec.feature_dim(C), C, mj,
               pad_input_to=pad_dim(jspec.feature_dim(C)))
    p = params_from_numpy([np.asarray(w) for w in jp.weights], [np.asarray(b) for b in jp.biases])
    n_bands, band_rows = rec._band_layout(H, 8)
    plane, scale = engine.pad_plane(torch.from_numpy(base), spec.D)
    for b in range(n_bands):
        r0 = min(b * band_rows, H - band_rows)
        want = np.asarray(jrec._residual_band_planes(jnp.asarray(base), jp, np.int32(r0), jspec,
                                                     mj, np.int32(K), H, W, band_rows))[:K]
        got = rec._residual_band_planes(plane, scale, p, r0, spec, ModelSpec(32, 2), K, H, W,
                                        band_rows).numpy()
        bits = lambda x: np.unpackbits(x, axis=1)[:, : C * band_rows * W]
        flips = np.count_nonzero((bits(got) != bits(want)).any(axis=0))
        assert flips <= 1e-3 * C * band_rows * W, flips
