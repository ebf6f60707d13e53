"""Port rate sweep vs the JAX package's: the expert step (K2's function),
`fit_rate_experts` and `encode_rate_points`, on numpy-seeded inputs.

Tolerances:
- one expert step vs the JAX kernel (interpret mode): K1's tiers of
  tests/test_fused_step.py:61-67 per expert (loss rtol 1e-5; m, v rtol
  1e-3; params rtol 2e-4 where |g| >= 1e-6, within 2*lr elsewhere);
- a whole fit vs the JAX fit: epoch losses and best MSE rtol 1e-5, best
  epoch exact, as tests/test_torch_train.py::test_fit_matches_jax;
- within the port, streams are byte-identical to `encode_image`'s.
"""

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
from lbdrn_msic_tpu.features import engine as jeng
from lbdrn_msic_tpu.models.siren import SirenParams as JParams
from lbdrn_msic_tpu.models.siren import init_params as jinit
from lbdrn_msic_tpu.ops import fused_step as jfs
from lbdrn_msic_tpu.train import loop as jloop
from lbdrn_msic_tpu_torch import codec
from lbdrn_msic_tpu_torch.core.config import CodecConfig, FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.eval.metrics import psnr
from lbdrn_msic_tpu_torch.models.siren import params_from_numpy, unstack_params
from lbdrn_msic_tpu_torch.ops import fused_step as fs
from lbdrn_msic_tpu_torch.train import loop
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

E = 3


def _expert_setup(bc, nl, dim_in, dim_out, B, mask_kind, seed=0):
    """E differently initialised networks, stacked, and one batch per
    expert; `mask_kind`: "shared" (one (B,) mask, 30 % zero) or
    "per_expert" ((E, B), densities 1.0, 0.6 and 0.0)."""
    jps = [jinit(jax.random.PRNGKey(seed + e), dim_in, dim_out, JModelSpec(bc, nl))
           for e in range(E)]
    ws = [np.stack([np.asarray(p.weights[l]) for p in jps]) for l in range(nl + 1)]
    bs = [np.stack([np.asarray(p.biases[l]) for p in jps]) for l in range(nl + 1)]
    rng = np.random.default_rng(seed + 1)
    x = (rng.standard_normal((E, B, ws[0].shape[1])) * 0.1).astype(np.float32)
    y = (1 / (1 + np.exp(-rng.standard_normal((E, B, dim_out))))).astype(np.float32)
    if mask_kind == "shared":
        mask = (rng.random(B) >= 0.3).astype(np.float32)
    else:
        mask = np.stack([(rng.random(B) < d).astype(np.float32) for d in (1.0, 0.6, 0.0)])
    return ws, bs, x, y, mask


def _port_state(ws, bs, device="cpu"):
    p = params_from_numpy(ws, bs, device)
    return p, p.map(torch.zeros_like), p.map(torch.zeros_like)


def _leaves(p):
    if isinstance(p, JParams):
        return [np.asarray(a) for a in list(p.weights) + list(p.biases)]
    return [a.cpu().numpy() for a in p.leaves()]


def _assert_expert_step_close(port, ref, loss, ref_loss):
    """K1's one-step tiers (tests/test_torch_fused_step.py::
    _assert_step_close), on every expert at once: one Adam step from zero
    state moves a param by ~lr*g/(|g|+eps), ill-conditioned for |g| < 1e-6,
    so params are held tightly only where |g| >= 1e-6."""
    pp, pm, pv = port
    rp, rm, rv = ref
    np.testing.assert_allclose(np.asarray(loss).reshape(-1), np.asarray(ref_loss).reshape(-1),
                               rtol=1e-5)
    for a, b in zip(_leaves(pm) + _leaves(pv), _leaves(rm) + _leaves(rv)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-10)
    for a, b, m in zip(_leaves(pp), _leaves(rp), _leaves(rm)):
        well = np.abs(m) / (1 - fs.ADAM_B1) >= 1e-6
        np.testing.assert_allclose(a[well], b[well], rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)


@pytest.mark.parametrize(
    "bc,nl,dim_in,dim_out,B,mask_kind",
    [(64, 2, 100, 4, 2048, "shared"), (64, 2, 100, 4, 1000, "per_expert"),
     (32, 1, 36, 2, 512, "shared"), (128, 3, 100, 8, 1000, "per_expert")],
)
def test_expert_step_matches_jax_kernel(bc, nl, dim_in, dim_out, B, mask_kind):
    """K2's function (`fused_expert_step` on CPU tensors) vs the JAX kernel
    in interpret mode: bench and wide widths, shared and per-expert masks,
    B = 1000 ragged for the card's 64-row CTAs."""
    ws, bs, x, y, mask = _expert_setup(bc, nl, dim_in, dim_out, B, mask_kind)
    jspec, spec = JModelSpec(bc, nl), ModelSpec(bc, nl)
    jp = JParams([jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    jz = jax.tree.map(jnp.zeros_like, jp)
    with pltpu.force_tpu_interpret_mode():
        jout = jfs.fused_expert_step(jp, jz, jz, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(mask), jnp.float32(1e-3), jnp.int32(1),
                                     jspec, dim_out, tile=B)
    port = _port_state(ws, bs)
    *_, loss = fs.fused_expert_step(*port, torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(mask), 1e-3, 1, spec, dim_out)
    assert loss.shape == (E,)
    _assert_expert_step_close(port, jout[:3], loss.numpy(), jout[3])
    if mask_kind == "per_expert":  # expert 2 saw no pixel: loss 0, params kept
        assert float(loss[2]) == 0.0
        for a, w in zip(_leaves(unstack_params(port[0], 2)), [w[2] for w in ws + bs]):
            np.testing.assert_array_equal(a, w)


def test_expert_step_bf16_matches_jax_kernel():
    """K2's function at mm_dtype "bfloat16" vs the JAX kernel at
    mm_dtype="bfloat16" in interpret mode (bench widths, per-expert masks):
    the bf16 tiers of tests/test_torch_fused_step.py::_assert_bf16_step_close
    (m, v within 2e-2 of the largest, loss rtol 1e-4, params tight where
    |g| is above the bf16 noise, within 2*lr elsewhere)."""
    ws, bs, x, y, mask = _expert_setup(64, 2, 100, 4, 1000, "per_expert", seed=8)
    jp = JParams([jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    jz = jax.tree.map(jnp.zeros_like, jp)
    with pltpu.force_tpu_interpret_mode():
        jout = jfs.fused_expert_step(jp, jz, jz, jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(mask), jnp.float32(1e-3), jnp.int32(1),
                                     JModelSpec(), 4, tile=1000, mm_dtype="bfloat16")
    pp, pm, pv = _port_state(ws, bs)
    *_, loss = fs.fused_expert_step(pp, pm, pv, torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(mask), 1e-3, 1, ModelSpec(), 4,
                                    mm_dtype="bfloat16")
    np.testing.assert_allclose(loss.numpy(), np.asarray(jout[3]), rtol=1e-4)
    for got, want in ((pm, jout[1]), (pv, jout[2])):
        scale = max(float(np.abs(b).max()) for b in _leaves(want))
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-2 * scale)
    gscale = max(float(np.abs(m).max()) for m in _leaves(jout[1]))
    for a, b, m in zip(_leaves(pp), _leaves(jout[0]), _leaves(jout[1])):
        well = np.abs(m) >= 2e-2 * gscale
        np.testing.assert_allclose(a[well], b[well], rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)


@pytest.mark.parametrize("mask_kind", ["shared", "per_expert"])
def test_expert_step_is_k1_per_expert(mask_kind):
    """Expert e of the expert step is K1's function on expert e's slices,
    bit for bit, and writes into the (E,) loss buffer it is given."""
    ws, bs, x, y, mask = _expert_setup(64, 2, 100, 4, 777, mask_kind, seed=4)
    spec = ModelSpec()
    port = _port_state(ws, bs)
    buf = torch.zeros((2, E))
    fs.fused_expert_step(*port, torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(mask), 1e-3, 1, spec, 4, loss_out=buf[1])
    assert float(buf[0].abs().sum()) == 0.0
    for e in range(E):
        one = _port_state([w[e] for w in ws], [b[e] for b in bs])
        m_e = mask[e] if mask.ndim == 2 else mask
        *_, l1 = fs.fused_train_step(*one, torch.from_numpy(x[e]), torch.from_numpy(y[e]),
                                     torch.from_numpy(m_e), 1e-3, 1, spec, 4)
        assert float(buf[1, e]) == float(l1)
        for st, st1 in zip(port, one):
            for a, b in zip(_leaves(unstack_params(st, e)), _leaves(st1)):
                np.testing.assert_array_equal(a, b)


def _jax_draws(key, n_g, dim_in, C, jspec, epochs):
    """The JAX fit_rate_experts' own draws (train/loop.py:722-724, 996-997)."""
    key, ik = jax.random.split(key)
    jp = jinit(ik, dim_in, C, jspec, pad_input_to=128)
    perms = []
    for _ in range(epochs):
        key, pk = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(pk, n_g)))
    return jp, perms


@pytest.mark.parametrize("use_fused,g", [(False, 8), (False, 1), (True, 8), (True, 1)])
def test_fit_rate_experts_matches_jax(use_fused, g):
    """48x40x4, bs 256, e=3, K in (3, 5, 6): the JAX init and permutations
    injected.  Epoch losses and best MSE rtol 1e-5 (summation order only,
    over 24 steps), best epoch exact, per expert."""
    H, W, C, e = 48, 40, 4, 3
    Ks = (3, 5, 6)
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=3)
    jspec, mspec = JModelSpec(), ModelSpec()
    jt = JTrainSpec(batch_size=256, epochs=e, sample_granule=g)
    t = TrainSpec(batch_size=256, epochs=e, sample_granule=g)
    key = jax.random.PRNGKey(11)
    mx = int(img.max())
    jdts = tuple(jnp.dtype(jeng.tap_matrix_dtype(mx >> k, True)).name for k in Ks)

    def run_jax():
        return jloop.fit_rate_experts(jnp.asarray(img), Ks, key, JFeatureSpec(), jspec, jt,
                                      H, W, C, jdts, use_fused=use_fused, staging="full")

    if use_fused:
        with pltpu.force_tpu_interpret_mode():
            ref = run_jax()
    else:
        ref = run_jax()
    jp, perms = _jax_draws(key, -(-H * W // g), 100, C, jspec, e)
    init = params_from_numpy([np.asarray(w) for w in jp.weights],
                             [np.asarray(b) for b in jp.biases])
    got = loop.fit_rate_experts(torch.from_numpy(img.astype(np.int32)), Ks, None,
                                FeatureSpec(), mspec, t, H, W, C, use_fused=use_fused,
                                init=init, perms=perms, device="cpu")

    assert got.step_losses.shape == ref.step_losses.shape
    assert got.params.weights[0].shape == ref.params.weights[0].shape
    np.testing.assert_allclose(got.step_losses[:, 0, 0].numpy(),
                               np.asarray(ref.step_losses[:, 0, 0]), rtol=1e-5)
    np.testing.assert_allclose(got.epoch_losses.numpy(), np.asarray(ref.epoch_losses),
                               rtol=1e-5)
    assert got.best_epoch == [int(v) for v in np.asarray(ref.best_epoch)]
    np.testing.assert_allclose(got.best_mse, np.asarray(ref.best_mse), rtol=1e-5)


def _cfgs(Ks, g=8, epochs=2, **kw):
    t = dict(epochs=epochs, batch_size=512, sample_granule=g)
    return ([CodecConfig(K=K, base_codec="lpc", train=TrainSpec(**t), **kw) for K in Ks],
            [JCodecConfig(K=K, base_codec="lpc", train=JTrainSpec(**t)) for K in Ks])


@pytest.fixture(scope="module")
def scene():
    return synth_scene(64, 56, channels=4, effective_bits=12, seed=21)


@pytest.mark.parametrize("use_fused,g", [(False, 8), (True, 8), (False, 1)])
def test_rate_points_byte_identical_to_encode_image(scene, use_fused, g):
    """Each rate point's stream is the port's `encode_image` stream at that
    K and seed, byte for byte; a second sweep gives the same bytes."""
    cfgs, _ = _cfgs((3, 5, 6), g=g)
    res = codec.encode_rate_points(scene, cfgs, use_fused=use_fused, device="cpu")
    again = codec.encode_rate_points(scene, cfgs, use_fused=use_fused, device="cpu")
    for cfg, (stream, stats), (stream2, _) in zip(cfgs, res, again):
        solo, solo_stats = codec.encode_image(scene, cfg, use_fused=use_fused, device="cpu")
        assert stream == solo and stream2 == stream
        assert stats.total_bytes == len(stream)
        assert stats.tiles[0].best_epoch == solo_stats.tiles[0].best_epoch
        assert stats.tiles[0].best_mse == solo_stats.tiles[0].best_mse


def test_rate_points_single_epoch(scene):
    cfgs, _ = _cfgs((4, 6), epochs=1)
    for cfg, (stream, stats) in zip(cfgs, codec.encode_rate_points(scene, cfgs, device="cpu")):
        solo, _ = codec.encode_image(scene, cfg, device="cpu")
        assert stream == solo and stats.tiles[0].best_epoch == 1


def test_rate_points_mixed_configs_fall_back(scene):
    """Configs that differ beyond K are encoded one by one: the same bytes
    as `encode_image`."""
    t = TrainSpec(epochs=1, batch_size=512)
    cfgs = [CodecConfig(K=4, base_codec="lpc", train=t),
            CodecConfig(K=5, base_codec="lpc", model=ModelSpec(32, 1), train=t)]
    assert not codec._experts_compatible(cfgs)
    for cfg, (stream, _) in zip(cfgs, codec.encode_rate_points(scene, cfgs, device="cpu")):
        assert stream == codec.encode_image(scene, cfg, device="cpu")[0]


def _flips_ok(a, b):
    """Residuals at rounding edges: +-1, on at most 0.1 % of the samples."""
    diff = a.astype(np.int32) - b.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= 1e-3 * diff.size


def test_rate_point_streams_cross_decode(scene):
    """Port sweep streams decode in the JAX package and JAX sweep streams in
    the port: header K right, MSBs exact, residual flips bounded."""
    Ks = (3, 6)
    cfgs, jcfgs = _cfgs(Ks)
    for K, (stream, _) in zip(Ks, codec.encode_rate_points(scene, cfgs, device="cpu")):
        own, dh = codec.decode_stream(stream, device="cpu")
        theirs, jdh = jcodec.decode_stream(stream)
        assert dh.header.K == jdh.header.K == K
        for rec in (own, theirs):
            assert np.array_equal(rec >> K, scene >> K)
        _flips_ok(own, theirs)
    for K, (stream, _) in zip(Ks, jcodec.encode_rate_points(scene, jcfgs)):
        own, dh = codec.decode_stream(stream, device="cpu")
        theirs, _ = jcodec.decode_stream(stream)
        assert dh.header.K == K
        assert np.array_equal(own >> K, scene >> K)
        _flips_ok(own, theirs)
        assert abs(psnr(scene, own) - psnr(scene, theirs)) < 0.1


def test_plan_rate_points_matches_jax_rule():
    """The bench sweep (2048^2 x 4, 12-bit, K 3..6) stages full tap
    matrices, int16 for K = 3, 4 and int8 for K = 5, 6, in one group; the
    byte counts are the JAX package's."""
    H = W = 2048
    img = np.zeros((4, H, W), np.uint16)
    img[0, 0, 0] = 4095
    cfgs, _ = _cfgs((3, 4, 5, 6))
    staging, dtypes, groups, per = codec.plan_rate_points(img, cfgs)
    assert staging == "full" and groups == [[0, 1, 2, 3]]
    assert dtypes == [torch.int16, torch.int16, torch.int8, torch.int8]
    for K, b in zip((3, 4, 5, 6), per):
        dt, rd = jeng.tap_matrix_dtype(4095 >> K, True), jeng.row_taps_dtype(4095 >> K)
        assert b == jcodec._staging_bytes(H, W, 4, JFeatureSpec(), 8, dt, rd)[0]
    assert sum(per) == 2 * 838860800 + 2 * 419430400  # ~2.5 GB of taps


def test_unported_sweep_paths_raise(scene, monkeypatch):
    cfgs, _ = _cfgs((4, 5))
    t = cfgs[0].train
    args = (torch.from_numpy(scene.astype(np.int32)), (4, 5), torch.Generator(),
            FeatureSpec(), ModelSpec(), t, 64, 56, 4)
    for kw in ({"img_of": (0, 0)}, {"hws": object()}):
        with pytest.raises(NotImplementedError):
            loop.fit_rate_experts(*args, device="cpu", **kw)
    # the banded expert fit is ported: W % 8 == 0, so the same networks as
    # the full one
    full, banded = (loop.fit_rate_experts(*args[:2], torch.Generator().manual_seed(1), *args[3:],
                                          use_fused=True, staging=st, device="cpu")
                    for st in ("full", "banded"))
    assert torch.equal(banded.step_losses, full.step_losses)
    assert banded.best_mse == full.best_mse
    # the multi-step path is ported: 7 steps an epoch as a 4-step chunk and
    # a 3-step one, bit for bit the per-step fit
    fits = [loop.fit_rate_experts(*args[:2], torch.Generator().manual_seed(1), *args[3:],
                                  use_fused=True, device="cpu", **kw)
            for kw in ({"multi_k": 4}, {})]
    assert torch.equal(fits[0].step_losses, fits[1].step_losses)
    assert fits[0].best_mse == fits[1].best_mse
    with pytest.raises(ValueError):
        loop.fit_rate_experts(*args, staging="cached", device="cpu")
    # the full tap matrices over budget -> banded staging: each point is
    # still the `encode_image` stream at its K
    monkeypatch.setattr(codec, "STAGE_BUDGET_BYTES", 64 * 56 * 4 * 25 - 1)
    assert codec.plan_rate_points(scene, cfgs)[0] == "banded"
    for cfg, (stream, _) in zip(cfgs, codec.encode_rate_points(scene, cfgs, device="cpu")):
        assert stream == codec.encode_image(scene, cfg, device="cpu")[0]


def test_rate_points_default_to_cuda(scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        codec.encode_rate_points(scene, _cfgs((4, 5))[0])


@pytest.mark.cuda
@pytest.mark.parametrize("bc,nl,dim_out,B,mask_kind",
                         [(64, 2, 4, 8192, "shared"), (64, 2, 4, 8192 - 37, "per_expert"),
                          (128, 3, 8, 1000, "per_expert")])
def test_k2_is_k1_per_expert_on_card(bc, nl, dim_out, B, mask_kind):
    """On the card, K2's expert e is K1 on expert e's slices bit for bit,
    each launch counted once (chip_smoke.py runs the same checks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    ws, bs, x, y, mask = _expert_setup(bc, nl, 100, dim_out, B, mask_kind, seed=11)
    spec = ModelSpec(bc, nl)
    k2 = _port_state(ws, bs, dev)
    xt, yt, mt = (torch.from_numpy(a).to(dev) for a in (x, y, mask))
    n2, n1 = fs.fused_expert_step.launches, fs.fused_train_step.launches
    *_, l2 = fs.fused_expert_step(*k2, xt, yt, mt, 1e-3, 1, spec, dim_out)
    for e in range(E):
        k1 = _port_state([w[e] for w in ws], [b[e] for b in bs], dev)
        *_, l1 = fs.fused_train_step(*k1, xt[e], yt[e], mt[e] if mt.dim() == 2 else mt,
                                     1e-3, 1, spec, dim_out)
        torch.cuda.synchronize()
        assert torch.equal(l2[e], l1)
        for st2, st1 in zip(k2, k1):
            for a, b in zip(unstack_params(st2, e).leaves(), st1.leaves()):
                assert torch.equal(a, b)
    assert fs.fused_expert_step.launches == n2 + 1
    assert fs.fused_train_step.launches == n1 + E
