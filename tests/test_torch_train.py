"""Port training loop vs the JAX package's, driven from the same init
params and epoch permutations (the JAX ones, injected into the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lbdrn_msic_tpu.core.config import FeatureSpec as JFeatureSpec
from lbdrn_msic_tpu.core.config import ModelSpec as JModelSpec
from lbdrn_msic_tpu.core.config import TrainSpec as JTrainSpec
from lbdrn_msic_tpu.features import engine as jeng
from lbdrn_msic_tpu.models.siren import init_params as jinit
from lbdrn_msic_tpu.train import loop as jloop
from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.features import engine
from lbdrn_msic_tpu_torch.models.siren import params_from_numpy
from lbdrn_msic_tpu_torch.train import loop
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

K = 5


@pytest.mark.parametrize("schedule", ["step", "cosine"])
@pytest.mark.parametrize("epochs", [1, 3, 10])
def test_lr_schedule_matches_jax(schedule, epochs):
    steps = 7
    jsched = jloop.make_lr_schedule(JTrainSpec(epochs=epochs, schedule=schedule), steps)
    sched = loop.make_lr_schedule(TrainSpec(epochs=epochs, schedule=schedule), steps)
    for s in range(epochs * steps):
        # both in float32; XLA's pow/cos may differ from numpy's by an ulp
        np.testing.assert_allclose(sched(s), float(jsched(jnp.int32(s))), rtol=1e-6, atol=1e-12)


def _prep(H, W, C, D=2):
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=3)
    jmsb, jlsb = jeng.split_msb_lsb(jnp.asarray(img), K)
    jplane, jscale = jeng.pad_plane(jmsb, D)
    msb, lsb = engine.split_msb_lsb(torch.from_numpy(img.astype(np.int32)), K)
    plane, scale = engine.pad_plane(msb, D)
    return img, (jplane, jscale, jlsb.astype(jnp.uint16)), (plane, scale, lsb)


@pytest.mark.parametrize("fast_act", [False, True])
def test_dataset_mse_matches_jax(fast_act):
    H, W, C = 29, 33, 4
    _, (jplane, jscale, jlsb), (plane, scale, lsb) = _prep(H, W, C)
    jspec, mspec = JModelSpec(), ModelSpec()
    jp = jinit(jax.random.PRNGKey(0), 100, C, jspec)
    p = params_from_numpy([np.asarray(w) for w in jp.weights], [np.asarray(b) for b in jp.biases])
    label_scale = np.float32(jeng.lsb_scale(K))
    R = 8  # several blocks, the last one clamped
    jx = jeng.build_feature_cache(jplane, jscale, JFeatureSpec(), H, W, 128)
    ref = jloop.dataset_mse(jp, jplane, jscale, jlsb, label_scale, JFeatureSpec(), jspec,
                            H, W, R, 128, x_cache=jx, fast_act=fast_act)
    x = engine.build_feature_cache(plane, scale, FeatureSpec(), H, W, 128)
    y = engine.build_label_matrix(lsb).to(torch.float32) * label_scale
    got = loop.dataset_mse(p, x, y, mspec, H, W, R, fast_act=fast_act)
    # one f32 sum over H*W*C terms in another order
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def _jax_draws(key, n_g, dim_in, C, jspec, epochs):
    """The JAX fit_core's own draws (train/loop.py:341-342, 508-509)."""
    key, ik = jax.random.split(key)
    jp = jinit(ik, dim_in, C, jspec, pad_input_to=128)
    perms = []
    for _ in range(epochs):
        key, pk = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(pk, n_g)))
    return jp, perms


@pytest.mark.parametrize("use_fused,g", [(True, 8), (False, 8), (False, 1)])
def test_fit_matches_jax(use_fused, g):
    """48x40x4, bs 256, e=3, g=8 (3 x 8 steps) or g=1.  Tolerances: epoch losses
    and best MSE rtol 1e-5 — the trajectories start identical and part only
    by f32 summation order (about 1e-7 relative over these 24 steps), which
    Adam can amplify at near-zero gradients; best_epoch is exact."""
    H, W, C, e = 48, 40, 4, 3
    _, (jplane, jscale, jlsb), (plane, scale, lsb) = _prep(H, W, C)
    jspec, mspec = JModelSpec(), ModelSpec()
    jt = JTrainSpec(batch_size=256, epochs=e, sample_granule=g)
    t = TrainSpec(batch_size=256, epochs=e, sample_granule=g)
    label_scale = np.float32(jeng.lsb_scale(K))
    key = jax.random.PRNGKey(11)

    def run_jax():
        return jloop.fit(jplane, jscale, jlsb, label_scale, key, JFeatureSpec(), jspec, jt,
                         H, W, C, staging="cached", use_fused=use_fused)

    if use_fused:
        with pltpu.force_tpu_interpret_mode():
            ref = run_jax()
    else:
        ref = run_jax()
    jp, perms = _jax_draws(key, -(-H * W // g), 100, C, jspec, e)
    init = params_from_numpy([np.asarray(w) for w in jp.weights],
                             [np.asarray(b) for b in jp.biases])
    got = loop.fit(plane, scale, lsb, float(label_scale), None, FeatureSpec(), mspec, t,
                   H, W, C, use_fused=use_fused, init=init, perms=perms, device="cpu")

    assert got.step_losses.shape == ref.step_losses.shape
    np.testing.assert_allclose(got.step_losses[0, 0].item(), float(ref.step_losses[0, 0]),
                               rtol=1e-5)
    np.testing.assert_allclose(got.epoch_losses.numpy(), np.asarray(ref.epoch_losses), rtol=1e-5)
    assert got.best_epoch == int(ref.best_epoch)
    np.testing.assert_allclose(got.best_mse, float(ref.best_mse), rtol=1e-5)


def test_fit_bf16_matches_jax():
    """`fit(mm_dtype="bfloat16")` vs the JAX fit at mm_dtype="bfloat16"
    (interpret mode), the JAX init and permutations injected: 48x40x4, bs
    256, g=8, e=3 (24 steps).  Epoch losses and best MSE rtol 1e-4, ten
    times the f32 fit's: a last-bit f32 difference upstream can flip an
    operand's bf16 rounding (2^-8 of one term of a sum), and Adam carries
    that on; best epoch exact.  The f32 fit is a different trajectory, and
    the port's one-expert `fit_rate_experts` at bf16 is this fit bit for
    bit (the expert step passes mm_dtype on)."""
    H, W, C, e, g = 48, 40, 4, 3, 8
    img, (jplane, jscale, jlsb), (plane, scale, lsb) = _prep(H, W, C)
    jt = JTrainSpec(batch_size=256, epochs=e, sample_granule=g)
    t = TrainSpec(batch_size=256, epochs=e, sample_granule=g)
    label_scale = np.float32(jeng.lsb_scale(K))
    key = jax.random.PRNGKey(11)
    with pltpu.force_tpu_interpret_mode():
        ref = jloop.fit(jplane, jscale, jlsb, label_scale, key, JFeatureSpec(), JModelSpec(), jt,
                        H, W, C, staging="cached", use_fused=True, mm_dtype="bfloat16")
    jp, perms = _jax_draws(key, H * W // g, 100, C, JModelSpec(), e)
    init = params_from_numpy([np.asarray(w) for w in jp.weights],
                             [np.asarray(b) for b in jp.biases])
    run = lambda mmd: loop.fit(plane, scale, lsb, float(label_scale), None, FeatureSpec(),
                               ModelSpec(), t, H, W, C, use_fused=True, mm_dtype=mmd, init=init,
                               perms=perms, device="cpu")
    got = run("bfloat16")
    np.testing.assert_allclose(got.epoch_losses.numpy(), np.asarray(ref.epoch_losses), rtol=1e-4)
    np.testing.assert_allclose(got.best_mse, float(ref.best_mse), rtol=1e-4)
    assert got.best_epoch == int(ref.best_epoch)
    f32 = run(None)
    assert not torch.equal(f32.step_losses, got.step_losses)
    expert = loop.fit_rate_experts(torch.from_numpy(img.astype(np.int32)), (K,), None,
                                   FeatureSpec(), ModelSpec(), t, H, W, C, use_fused=True,
                                   mm_dtype="bfloat16", init=init, perms=perms, device="cpu")
    assert torch.equal(expert.step_losses[0], got.step_losses)


def test_fit_single_epoch_takes_final_params():
    H, W, C = 24, 20, 4
    _, _, (plane, scale, lsb) = _prep(H, W, C)
    t = TrainSpec(batch_size=128, epochs=1, sample_granule=1)
    r = loop.fit(plane, scale, lsb, engine.lsb_scale(K), torch.Generator().manual_seed(0),
                 FeatureSpec(), ModelSpec(), t, H, W, C, device="cpu")
    assert r.best_epoch == 1
    assert r.step_losses.shape == (1, -(-H * W // 128))
    np.testing.assert_allclose(r.best_mse, float(r.step_losses[0].mean()), rtol=1e-6)
    for a, b in zip(r.params.leaves(), r.final_params.leaves()):
        assert torch.equal(a, b)
