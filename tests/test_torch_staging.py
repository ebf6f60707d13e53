"""Port staging modes above the feature-cache budget vs the JAX package's:
"full", "banded" and "gather" batches in `fit`, "banded" in the rate sweep.

Tolerances:
- engine functions: integers exactly, f32 features bit for bit;
- a whole fit vs the JAX fit: epoch losses and best MSE rtol 1e-5, best
  epoch exact (tests/test_torch_train.py::test_fit_matches_jax's tiers: the
  trajectories start identical and part only by f32 summation order);
- within the port: every mode's fit bit for bit the "cached" fit where the
  granule grids coincide, `multi_k` bit for bit the per-step fit, and a
  banded sweep's expert bit for bit the banded `fit` at its K.
"""

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
from lbdrn_msic_tpu_torch.features import engine
from lbdrn_msic_tpu_torch.models.siren import params_from_numpy
from lbdrn_msic_tpu_torch.train import loop
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

K = 5
SHAPES = [(24, 37), (32, 40)]  # W % 8 != 0 and == 0


def _bits(a):
    return np.asarray(a).astype(np.float32).view(np.uint32)


def _planes(H, W, C, D, K_=K, seed=0):
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=seed)
    jmsb, jlsb = jeng.split_msb_lsb(jnp.asarray(img), K_)
    jplane, jscale = jeng.pad_plane(jmsb, D)
    msb, lsb = engine.split_msb_lsb(torch.from_numpy(img.astype(np.int32)), K_)
    plane, scale = engine.pad_plane(msb, D)
    return img, (jplane, jscale, jlsb.astype(jnp.uint16)), (plane, scale, lsb)


# (K, the raw plane's max >> K of a 12-bit scene) -> JAX and port raw dtypes
RAW_CASES = [(3, "uint16", torch.int16), (5, "uint8", torch.uint8)]


@pytest.mark.parametrize("K_,jdtype,dtype", RAW_CASES)
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("H,W", SHAPES)
def test_banded_staging_identical(H, W, D, g, K_, jdtype, dtype):
    """`build_row_taps` holds the JAX values in every raw dtype; the
    banded features of every granule (padding columns included) are the
    JAX function's bit for bit, relative or not, and in-image pixels equal
    the slice path's."""
    C = 3 if g == 1 else 4
    img, (jplane, _, _), (plane, scale, _) = _planes(H, W, C, D, K_)
    mx = int(img.max()) >> K_
    assert jnp.dtype(jeng.row_taps_dtype(mx)).name == jdtype
    assert engine.row_taps_dtype(mx) == dtype
    Wg, ng_row = engine.banded_geometry(W, g)
    assert (Wg, ng_row) == jeng.banded_geometry(W, g)
    jspec, spec = JFeatureSpec(D=D), FeatureSpec(D=D)
    ref = jeng.build_row_taps(jplane, jspec, H, W, g, jnp.dtype(jdtype))
    got = engine.build_row_taps(plane, spec, H, W, g, dtype)
    assert got.dtype == dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(ref).astype(np.int64))
    gidx = np.random.default_rng(g).permutation(H * ng_row)[:200]
    for relative in (True, False):
        jspec, spec = JFeatureSpec(D=D, relative=relative), FeatureSpec(D=D, relative=relative)
        jscale = jnp.asarray(scale.numpy())
        jx = jeng.banded_window_features(ref, jscale, jnp.asarray(gidx), jspec, H, W, g)
        x = engine.banded_window_features(got, scale, torch.from_numpy(gidx), spec, H, W, g)
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(jx))
        # written into a padded batch buffer, and against the slice path
        F = x.shape[1]
        buf = torch.zeros((len(gidx) * g, 128))
        engine.banded_window_features(got, scale, torch.from_numpy(gidx), spec, H, W, g,
                                      out=buf[:, :F])
        np.testing.assert_array_equal(_bits(buf[:, :F].numpy()), _bits(x.numpy()))
        assert not buf[:, F:].any()
        full = engine.row_block_features(plane, scale, 0, spec, H, W, H).view(H, W, F)
        jj = (gidx % ng_row * g)[:, None] + np.arange(g)
        inside = (jj < W).reshape(-1)
        ii = np.repeat(gidx // ng_row, g)
        np.testing.assert_array_equal(
            _bits(x.numpy()[inside]), _bits(full[ii[inside], jj.reshape(-1)[inside]].numpy()))


@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("C", [3, 4])
@pytest.mark.parametrize("H,W", SHAPES)
def test_banded_labels_identical(H, W, C, g):
    _, (_, _, jlsb), (_, _, lsb) = _planes(H, W, C, 2)
    ref = np.asarray(jeng.build_banded_labels(jlsb, H, W, g))
    got = engine.build_banded_labels(lsb, H, W, g)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))


@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("C", [3, 4])
def test_gather_path_identical(C, D, relative):
    """`gather_features`, `gather_pixel_labels` and `gather_labels` against
    the JAX functions (ids past the image clipped), and the gathered
    features against the slice path."""
    H, W = SHAPES[0]
    _, (jplane, jscale, jlsb), (plane, scale, lsb) = _planes(H, W, C, D)
    jspec, spec = JFeatureSpec(D=D, relative=relative), FeatureSpec(D=D, relative=relative)
    idx = np.random.default_rng(C + D).integers(0, H * W + 40, 300).astype(np.int32)
    jx = jeng.gather_features(jplane, jscale, jnp.asarray(idx), jspec, H, W)
    x = engine.gather_features(plane, scale, torch.from_numpy(idx).long(), spec, H, W)
    np.testing.assert_array_equal(_bits(x.numpy()), _bits(jx))
    buf = torch.zeros((len(idx), 128))
    engine.gather_features(plane, scale, torch.from_numpy(idx).long(), spec, H, W,
                           out=buf[:, : x.shape[1]])
    np.testing.assert_array_equal(_bits(buf[:, : x.shape[1]].numpy()), _bits(x.numpy()))
    full = engine.row_block_features(plane, scale, 0, spec, H, W, H)
    np.testing.assert_array_equal(_bits(x.numpy()),
                                  _bits(full[np.minimum(idx, H * W - 1)].numpy()))

    clipped = np.minimum(idx, H * W - 1)
    store = jeng.build_granule_labels(jlsb, H, W, jeng.LABEL_STORE_G)
    jrows = np.asarray(jeng.gather_pixel_labels(store, jnp.asarray(clipped), C))
    labels = engine.build_label_matrix(lsb)
    rows = engine.gather_pixel_labels(labels, torch.from_numpy(clipped).long())
    np.testing.assert_array_equal(rows.numpy(), jrows.astype(np.int32))
    ls = np.float32(jeng.lsb_scale(K))
    jy = jeng.gather_labels(jeng.build_label_matrix(jlsb), jnp.float32(ls), jnp.asarray(idx))
    y = engine.gather_labels(labels, ls, torch.from_numpy(idx).long())
    np.testing.assert_array_equal(_bits(y.numpy()), _bits(jy))


def _jax_draws(key, n_g, C, epochs):
    """The JAX fit's own init params and epoch permutations (train/loop.py
    fit_core :341-342, :508-509; fit_rate_experts likewise)."""
    key, ik = jax.random.split(key)
    jp = jinit(ik, 100, C, JModelSpec(), pad_input_to=128)
    perms = []
    for _ in range(epochs):
        key, pk = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(pk, n_g)))
    init = params_from_numpy([np.asarray(w) for w in jp.weights],
                             [np.asarray(b) for b in jp.biases])
    return init, perms


def _same(a, b):
    return (torch.equal(a.step_losses, b.step_losses) and a.best_mse == b.best_mse
            and a.best_epoch == b.best_epoch
            and all(torch.equal(x, y) for x, y in zip(a.params.leaves(), b.params.leaves())))


# staging -> the JAX tap dtype at K = 5 of a 12-bit scene (MSB max 127)
JAX_TAP_DTYPE = {"full": "int8", "banded": "uint8", "gather": "int16"}


@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("staging", ["full", "banded", "gather"])
def test_fit_modes_match_jax(staging, use_fused):
    """24x37x4 (W % 8 != 0: the banded grid pads 3 columns a row), bs 256,
    g=8, e=3: `fit(staging=s)` vs the JAX `fit(staging=s)` (fused in
    interpret mode, or the exact step), the JAX init and permutations
    injected.  Epoch losses and best MSE rtol 1e-5, best epoch exact."""
    H, W, C, e = 24, 37, 4, 3
    _, (jplane, jscale, jlsb), (plane, scale, lsb) = _planes(H, W, C, 2, seed=3)
    jt = JTrainSpec(batch_size=256, epochs=e, sample_granule=8)
    t = TrainSpec(batch_size=256, epochs=e, sample_granule=8)
    ls = np.float32(jeng.lsb_scale(K))
    key = jax.random.PRNGKey(11)

    def run_jax():
        return jloop.fit(jplane, jscale, jlsb, ls, key, JFeatureSpec(), JModelSpec(), jt, H, W, C,
                         staging=staging, tap_dtype=JAX_TAP_DTYPE[staging], use_fused=use_fused)

    if use_fused:
        with pltpu.force_tpu_interpret_mode():
            ref = run_jax()
    else:
        ref = run_jax()
    geo = loop._batch_geometry(t, H, W, staging)
    assert (geo.g, geo.n_g) == {"full": (8, 111), "banded": (8, 120), "gather": (1, 888)}[staging]
    init, perms = _jax_draws(key, geo.n_g, C, e)
    got = loop.fit(plane, scale, lsb, float(ls), None, FeatureSpec(), ModelSpec(), t, H, W, C,
                   staging=staging, use_fused=use_fused, init=init, perms=perms, device="cpu")
    assert got.step_losses.shape == ref.step_losses.shape
    np.testing.assert_allclose(got.epoch_losses.numpy(), np.asarray(ref.epoch_losses), rtol=1e-5)
    assert got.best_epoch == int(ref.best_epoch)
    np.testing.assert_allclose(got.best_mse, float(ref.best_mse), rtol=1e-5)


@pytest.mark.parametrize("g", [8, 1])
@pytest.mark.parametrize("H,W", SHAPES)
def test_fit_modes_identical_within_port(H, W, g):
    """Every mode feeds the step values bit-identical to the feature
    cache's: where the granule grids coincide ("full" always, "banded" at
    W % g == 0, "gather" at g = 1) the fit is the "cached" fit bit for bit,
    fused and exact; and each mode's fit at multi_k=3 is its per-step fit
    bit for bit."""
    C = 4
    _, _, (plane, scale, lsb) = _planes(H, W, C, 2, seed=3)
    t = TrainSpec(batch_size=256, epochs=3, sample_granule=g)

    def run(staging, use_fused=True, multi_k=0):
        return loop.fit(plane, scale, lsb, engine.lsb_scale(K), torch.Generator().manual_seed(1),
                        FeatureSpec(), ModelSpec(), t, H, W, C, staging=staging,
                        use_fused=use_fused, multi_k=multi_k, device="cpu")

    cached = run("cached")
    for staging in ("full", "banded", "gather"):
        fit = run(staging)
        coincide = staging == "full" or g == 1 or (staging == "banded" and W % g == 0)
        assert _same(fit, cached) == coincide, staging
        assert _same(run(staging, multi_k=3), fit), staging
    assert _same(run("full", use_fused=False), run("cached", use_fused=False))


def test_fit_rate_experts_banded_matches_jax():
    """24x37x4, bs 256, g=8, e=3, K in (3, 5): the banded sweep (raw dtypes
    uint16 / uint8; port int16 / uint8) vs the JAX one in interpret mode,
    the JAX init and permutations injected: epoch losses and best MSE rtol
    1e-5, best epoch exact, per expert.  Within the port, each expert is the
    banded `fit` at its K bit for bit, per step and at multi_k=3."""
    H, W, C, e = 24, 37, 4, 3
    Ks = (3, 5)
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=3)
    jt = JTrainSpec(batch_size=256, epochs=e, sample_granule=8)
    t = TrainSpec(batch_size=256, epochs=e, sample_granule=8)
    key = jax.random.PRNGKey(11)
    with pltpu.force_tpu_interpret_mode():
        ref = jloop.fit_rate_experts(jnp.asarray(img), Ks, key, JFeatureSpec(), JModelSpec(), jt,
                                     H, W, C, ("uint16", "uint8"), use_fused=True,
                                     staging="banded")
    init, perms = _jax_draws(key, H * 5, C, e)
    timg = torch.from_numpy(img.astype(np.int32))
    run = lambda **kw: loop.fit_rate_experts(timg, Ks, None, FeatureSpec(), ModelSpec(), t, H, W,
                                             C, use_fused=True, staging="banded", init=init,
                                             perms=perms, device="cpu", **kw)
    got = run()
    np.testing.assert_allclose(got.epoch_losses.numpy(), np.asarray(ref.epoch_losses), rtol=1e-5)
    assert got.best_epoch == [int(v) for v in np.asarray(ref.best_epoch)]
    np.testing.assert_allclose(got.best_mse, np.asarray(ref.best_mse), rtol=1e-5)
    chunked = run(multi_k=3)
    assert torch.equal(chunked.step_losses, got.step_losses)
    assert chunked.best_mse == got.best_mse and chunked.best_epoch == got.best_epoch
    for e_, K_ in enumerate(Ks):
        msb, lsb = engine.split_msb_lsb(timg, K_)
        plane, scale = engine.pad_plane(msb, 2)
        one = loop.fit(plane, scale, lsb, engine.lsb_scale(K_), None, FeatureSpec(), ModelSpec(),
                       t, H, W, C, staging="banded", use_fused=True, init=init, perms=perms,
                       device="cpu")
        assert torch.equal(got.step_losses[e_], one.step_losses)
        assert got.best_mse[e_] == one.best_mse and got.best_epoch[e_] == one.best_epoch
        for a, b in zip(got.params.leaves(), one.params.leaves()):
            assert torch.equal(a[e_], b)


# (H, W, C): the bench scene, a 4096^2 tile, the reference scenes (GF-2,
# GF-6 WFI and PMS), and one above every staged layout's budget
PICK_SHAPES = [(2048, 2048, 4), (4096, 4096, 4), (7605, 7815, 4), (7340, 7815, 4),
               (6000, 6000, 8), (6000, 6000, 4), (20000, 20000, 8)]


@pytest.mark.parametrize("K_", [3, 4, 5, 6])
def test_pick_staging_matches_jax(K_):
    """Mode and dtype of `pick_staging` equal the JAX package's on the
    reference shapes at 12 bits (the port holds JAX's uint16 as int16), and
    the gather fallback warns in both."""
    ts, jts = TrainSpec(sample_granule=8), JTrainSpec(sample_granule=8)
    as_port = {"float32": torch.float32, "int8": torch.int8, "int16": torch.int16,
               "uint8": torch.uint8, "uint16": torch.int16}
    for H, W, C in PICK_SHAPES:
        for relative in (True, False):
            fs, jfs = FeatureSpec(relative=relative), JFeatureSpec(relative=relative)
            with warnings.catch_warnings(record=True) as jw:
                warnings.simplefilter("always")
                ref, jdt = jcodec.pick_staging(H, W, C, 4095 >> K_, jfs, jts)
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                got, dt = codec.pick_staging(H, W, C, 4095 >> K_, fs, ts)
            assert got == ref, (H, W, C, relative)
            jname = jnp.dtype(jdt).name
            if not relative and got != "banded" and jname == "uint16":
                assert dt == torch.int32  # absolute taps above 255 (engine.tap_matrix_dtype)
            else:
                assert dt == as_port[jname], (H, W, C, relative, jname, dt)
            warned = [x for x in w if issubclass(x.category, RuntimeWarning)]
            assert len(warned) == (got == "gather") == len(
                [x for x in jw if issubclass(x.category, RuntimeWarning)])
    assert codec.pick_staging(7605, 7815, 4, 4095 >> K_, FeatureSpec(), ts)[0] == (
        "banded" if K_ < 5 else "full")


def _cfg(K_, epochs=2):
    return CodecConfig(K=K_, base_codec="lpc",
                       train=TrainSpec(epochs=epochs, batch_size=512, sample_granule=8))


def test_encode_above_budget_modes(monkeypatch):
    """With the budget shrunk, a 40x44x4 scene (W % 8 != 0) encodes through
    each mode that `pick_staging` then picks: "full" gives the "cached"
    stream byte for byte; "banded" and "gather" round-trip (MSBs exact,
    PSNR within 0.5 dB of the cached encode); a banded sweep's points are
    `encode_image`'s streams, and a sweep above the banded budget is
    `encode_image` per point."""
    scene = synth_scene(40, 44, channels=4, effective_bits=12, seed=5)
    cfg = _cfg(K)
    cached, _ = codec.encode_image(scene, cfg, device="cpu")
    rec = codec.decode_stream(cached, device="cpu")[0]
    p_cached = float(np.mean((rec.astype(np.float64) - scene) ** 2))
    C, H, W = scene.shape
    cache = codec._cached_bytes(H, W, C, cfg.features, 8)
    full, banded = codec._staging_bytes(H, W, C, cfg.features, 8, 1, 1)
    for budget, want in ((cache - 1, "full"), (full - 1, "banded"), (banded - 1, "gather")):
        monkeypatch.setattr(codec, "STAGE_BUDGET_BYTES", budget)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            assert codec.pick_staging(H, W, C, int(scene.max()) >> K, cfg.features,
                                      cfg.train)[0] == want
            stream, _ = codec.encode_image(scene, cfg, device="cpu")
        got = codec.decode_stream(stream, device="cpu")[0]
        assert np.array_equal(got >> K, scene >> K), want
        if want == "full":
            assert stream == cached
        mse = float(np.mean((got.astype(np.float64) - scene) ** 2))
        assert abs(10 * np.log10(mse / p_cached)) < 0.5, (want, mse, p_cached)

    cfgs = [_cfg(3), _cfg(5)]
    for budget, want in ((full - 1, "banded"), (banded - 1, "gather")):
        monkeypatch.setattr(codec, "STAGE_BUDGET_BYTES", budget)
        staging, dtypes, groups, _ = codec.plan_rate_points(scene, cfgs)
        assert staging == want
        if want == "banded":
            assert dtypes == [torch.int16, torch.uint8] and groups == [[0, 1]]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            res = codec.encode_rate_points(scene, cfgs, device="cpu")
            for c, (stream, _) in zip(cfgs, res):
                assert stream == codec.encode_image(scene, c, device="cpu")[0], (want, c.K)


@pytest.mark.cuda
def test_forced_modes_on_card():
    """On the card (chip_smoke.py's staging phase (a) at a small size):
    "full" and "banded" at W % 8 == 0 are the "cached" fit bit for bit,
    "gather" is it at granule 1, each fit launching K1 epochs x steps
    times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from lbdrn_msic_tpu_torch.ops import fused_step as fs

    H, W, C = 256, 256, 4
    _, _, (plane, scale, lsb) = _planes(H, W, C, 2, seed=3)
    for g, modes in ((8, ("full", "banded")), (1, ("gather",))):
        t = TrainSpec(epochs=2, sample_granule=g)
        fits = {}
        for staging in ("cached", *modes):
            fs.fused_train_step.launches = 0
            fits[staging] = loop.fit(plane, scale, lsb, engine.lsb_scale(K),
                                     torch.Generator().manual_seed(1), FeatureSpec(),
                                     ModelSpec(), t, H, W, C, staging=staging)
            geo = loop._batch_geometry(t, H, W, staging)
            assert fs.fused_train_step.launches == t.epochs * geo.steps
        for staging in modes:
            assert _same(fits[staging], fits["cached"]), staging
