"""Port multi-step paths vs the JAX package's: the k-step functions of K3
(`fused_multi_step`) and K4 (`fused_expert_multi_step`), the `multi_k`
rule, and `fit` / `fit_rate_experts` trained in k-step chunks.

Tolerances:
- one k-step chunk vs the JAX kernel (interpret mode): K1's tiers of
  tests/test_fused_step.py:61-67 (loss rtol 1e-5; m, v rtol 1e-3; params
  rtol 2e-4 where |g| >= 1e-6, within 2*lr elsewhere);
- a whole chunked fit vs the JAX chunked fit: epoch losses and best MSE
  rtol 1e-5, best epoch exact, as tests/test_torch_train.py;
- within the port, a chunked fit or a k-step call equals the per-step one
  bit for bit (on the card too: the `cuda` cases).
"""

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
from lbdrn_msic_tpu.models.siren import SirenParams as JParams
from lbdrn_msic_tpu.models.siren import init_params as jinit
from lbdrn_msic_tpu.ops import fused_step as jfs
from lbdrn_msic_tpu.train import loop as jloop
from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.features import engine
from lbdrn_msic_tpu_torch.models.siren import params_from_numpy, unstack_params
from lbdrn_msic_tpu_torch.ops import fused_step as fs
from lbdrn_msic_tpu_torch.train import loop
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

K = 5


def _setup(bc, nl, dim_in, dim_out, B, k, E=None, seed=0):
    """JAX-initialised params (E stacked networks, or one) and k steps of
    numpy batches: X (k, [E,] B, F), Y likewise, (k, B) masks with a
    masked tail on step 1."""
    nets = [jinit(jax.random.PRNGKey(seed + e), dim_in, dim_out, JModelSpec(bc, nl))
            for e in range(E or 1)]
    if E is None:
        ws = [np.asarray(w) for w in nets[0].weights]
        bs = [np.asarray(b) for b in nets[0].biases]
    else:
        ws = [np.stack([np.asarray(p.weights[l]) for p in nets]) for l in range(nl + 1)]
        bs = [np.stack([np.asarray(p.biases[l]) for p in nets]) for l in range(nl + 1)]
    lead = (k,) if E is None else (k, E)
    rng = np.random.default_rng(seed + 1)
    X = (rng.standard_normal((*lead, B, ws[0].shape[-2])) * 0.1).astype(np.float32)
    Y = (1 / (1 + np.exp(-rng.standard_normal((*lead, B, dim_out))))).astype(np.float32)
    masks = np.ones((k, B), np.float32)
    masks[1, -17:] = 0.0
    return ws, bs, X, Y, masks


def _state(ws, bs, device="cpu"):
    p = params_from_numpy(ws, bs, device)
    return p, p.map(torch.zeros_like), p.map(torch.zeros_like)


def _leaves(p):
    if isinstance(p, JParams):
        return [np.asarray(a) for a in list(p.weights) + list(p.biases)]
    return [a.cpu().numpy() for a in p.leaves()]


def _assert_chunk_close(port, ref, losses, ref_losses, lr):
    """K1's tiers, on a whole chunk: near-zero gradients make an Adam step
    ill-conditioned, so params are held tightly only where |g| >= 1e-6."""
    np.testing.assert_allclose(np.asarray(losses), np.asarray(ref_losses), rtol=1e-5)
    for a, b in zip(_leaves(port[1]) + _leaves(port[2]), _leaves(ref[1]) + _leaves(ref[2])):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-10)
    for a, b, m in zip(_leaves(port[0]), _leaves(ref[0]), _leaves(ref[1])):
        well = np.abs(m) / (1 - fs.ADAM_B1) >= 1e-6
        np.testing.assert_allclose(a[well], b[well], rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr)


def _same(st_a, st_b):
    return all(torch.equal(a, b) for pa, pb in zip(st_a, st_b)
               for a, b in zip(pa.leaves(), pb.leaves()))


LRS = [1e-3, 1e-3, 1e-4, 1e-4]


def test_multi_step_matches_jax_kernel():
    """K3's function (`fused_multi_step` on CPU tensors) vs the JAX kernel
    in interpret mode: bc=32, nl=2, B=1024, k=4, a schedule, a masked tail,
    a mid-fit Adam step0 = 3 (tests/test_fused_step.py:104-146)."""
    ws, bs, X, Y, masks = _setup(32, 2, 36, 2, 1024, 4)
    jspec, spec = JModelSpec(32, 2), ModelSpec(32, 2)
    jp = JParams([jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    jz = jax.tree.map(jnp.zeros_like, jp)
    with pltpu.force_tpu_interpret_mode():
        jout = jfs.fused_multi_step(jp, jz, jz, jnp.asarray(X), jnp.asarray(Y),
                                    jnp.asarray(masks), jnp.float32(LRS), jnp.int32(3), jspec, 2)
    port = _state(ws, bs)
    *_, losses = fs.fused_multi_step(*port, torch.from_numpy(X), torch.from_numpy(Y),
                                     torch.from_numpy(masks), LRS, 3, spec, 2)
    assert losses.shape == (4,)
    _assert_chunk_close(port, jout[:3], losses.numpy(), jout[3], max(LRS))


def test_expert_multi_step_matches_jax_kernel():
    """K4's function vs the JAX kernel in interpret mode: E=3 different
    networks, one mask per step shared by the experts, step0 = 2
    (tests/test_fused_step.py:243-285).  Losses are (k, E), the JAX
    kernel's (E, k) transposed."""
    lrs = [1e-3, 5e-4, 5e-4, 1e-4]
    ws, bs, X, Y, masks = _setup(32, 2, 36, 3, 1024, 4, E=3, seed=20)
    jspec, spec = JModelSpec(32, 2), ModelSpec(32, 2)
    jp = JParams([jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    jz = jax.tree.map(jnp.zeros_like, jp)
    with pltpu.force_tpu_interpret_mode():
        jout = jfs.fused_expert_multi_step(jp, jz, jz, jnp.asarray(X), jnp.asarray(Y),
                                           jnp.asarray(masks), jnp.float32(lrs), jnp.int32(2),
                                           jspec, 3)
    port = _state(ws, bs)
    *_, losses = fs.fused_expert_multi_step(*port, torch.from_numpy(X), torch.from_numpy(Y),
                                            torch.from_numpy(masks), lrs, 2, spec, 3)
    assert losses.shape == (4, 3)
    _assert_chunk_close(port, jout[:3], losses.numpy().T, jout[3], max(lrs))


def _assert_bf16_chunk_close(port, ref, losses, ref_losses, n_steps, lr):
    """A chunk at mm_dtype "bfloat16" vs the JAX kernel's: the bf16 tiers of
    tests/test_torch_fused_step.py::_assert_bf16_step_close (m, v within
    2e-2 of the largest, loss rtol 1e-4, params tight where |g| is above
    the bf16 noise, within 2*lr a step elsewhere)."""
    np.testing.assert_allclose(np.asarray(losses), np.asarray(ref_losses), rtol=1e-4)
    for got, want in ((port[1], ref[1]), (port[2], ref[2])):
        scale = max(float(np.abs(b).max()) for b in _leaves(want))
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-2 * scale)
    gscale = max(float(np.abs(m).max()) for m in _leaves(ref[1]))
    for a, b, m in zip(_leaves(port[0]), _leaves(ref[0]), _leaves(ref[1])):
        well = np.abs(m) >= 2e-2 * gscale
        np.testing.assert_allclose(a[well], b[well], rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr * n_steps)


@pytest.mark.parametrize("E", [None, 3])
def test_multi_step_bf16_matches_jax_kernel(E):
    """K3's (E=None) and K4's (E=3) functions at mm_dtype "bfloat16" vs the
    JAX kernels at mm_dtype="bfloat16" in interpret mode: bench widths,
    B=1024, k=2 from step0 = 3, a masked tail on step 1."""
    lrs = [1e-3, 5e-4]
    ws, bs, X, Y, masks = _setup(64, 2, 100, 4, 1024, 2, E=E, seed=30)
    jp = JParams([jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    jz = jax.tree.map(jnp.zeros_like, jp)
    jfn, fn = ((jfs.fused_multi_step, fs.fused_multi_step) if E is None else
               (jfs.fused_expert_multi_step, fs.fused_expert_multi_step))
    with pltpu.force_tpu_interpret_mode():
        jout = jfn(jp, jz, jz, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(masks),
                   jnp.float32(lrs), jnp.int32(3), JModelSpec(), 4, mm_dtype="bfloat16")
    port = _state(ws, bs)
    *_, losses = fn(*port, torch.from_numpy(X), torch.from_numpy(Y), torch.from_numpy(masks),
                    lrs, 3, ModelSpec(), 4, mm_dtype="bfloat16")
    jl = np.asarray(jout[3]) if E is None else np.asarray(jout[3]).T
    _assert_bf16_chunk_close(port, jout[:3], losses.numpy(), jl, 2, max(lrs))


def test_multi_step_is_chained_steps():
    """K3's function is k chained `fused_train_step` calls bit for bit, and
    expert e of K4's is K3's on expert e's slices; both write into the
    loss buffers they are given."""
    spec = ModelSpec()
    ws, bs, X, Y, masks = _setup(64, 2, 100, 4, 777, 4, seed=5)
    multi, chained = _state(ws, bs), _state(ws, bs)
    buf = torch.zeros((2, 4))
    fs.fused_multi_step(*multi, torch.from_numpy(X), torch.from_numpy(Y),
                        torch.from_numpy(masks), LRS, 3, spec, 4, loss_out=buf[1])
    assert float(buf[0].abs().sum()) == 0.0
    for s in range(4):
        *_, l1 = fs.fused_train_step(*chained, torch.from_numpy(X[s]), torch.from_numpy(Y[s]),
                                     torch.from_numpy(masks[s]), LRS[s], 3 + s, spec, 4)
        assert float(buf[1, s]) == float(l1)
    assert _same(multi, chained)

    E = 3
    ws, bs, X, Y, masks = _setup(64, 2, 100, 4, 777, 4, E=E, seed=6)
    experts = _state(ws, bs)
    *_, lk4 = fs.fused_expert_multi_step(*experts, torch.from_numpy(X), torch.from_numpy(Y),
                                         torch.from_numpy(masks), LRS, 3, spec, 4)
    for e in range(E):
        one = _state([w[e] for w in ws], [b[e] for b in bs])
        *_, lk3 = fs.fused_multi_step(*one, torch.from_numpy(X[:, e].copy()),
                                      torch.from_numpy(Y[:, e].copy()), torch.from_numpy(masks),
                                      LRS, 3, spec, 4)
        assert torch.equal(lk4[:, e], lk3)
        assert _same(tuple(unstack_params(st, e) for st in experts), one)


def _jax_multi_k(multi_k, E, bs, padded_in, steps, hws, use_fused=True):
    """The JAX package's rule as written in lbdrn_msic_tpu/train/loop.py
    (:333-339 for fit, E = 1; :739-752 for fit_rate_experts), with its
    VMEM gate evaluated by the JAX package's own `pick_tile`."""
    if hws:
        multi_k = 0
    if use_fused and multi_k and jfs.pick_tile(bs, padded_in, 4, JModelSpec()) == bs:
        cap = max(1, (512 << 20) // (E * bs * padded_in * 4))
        multi_k = min(multi_k, cap, steps)
        return multi_k if multi_k >= 2 else 0
    return 0


@pytest.mark.parametrize("E,hws", [(1, False), (3, False), (3, True)])
@pytest.mark.parametrize("multi_k,steps", [(1, 4), (3, 4), (9, 4), (5000, 4000)])
def test_multi_k_rule_matches_jax(multi_k, steps, E, hws):
    """k in {1, 3, steps + 5, above the cap (512 MB of staged batches:
    1024 // E steps at bs 1024)}, for `fit` (E = 1) and the expert loop,
    with and without per-expert bucket masks; off without the fused step."""
    bs, padded_in = 1024, 128
    got = loop.multi_step_k(multi_k, True, E, bs, padded_in, steps, hws)
    assert got == _jax_multi_k(multi_k, E, bs, padded_in, steps, hws)
    assert loop.multi_step_k(multi_k, False, E, bs, padded_in, steps, hws) == 0
    assert loop.multi_step_k(None, True, E, bs, padded_in, steps, hws) == 0
    if multi_k == 5000 and not hws:
        assert got == 1024 // E


def _jax_draws(key, n_g, dim_in, C, jspec, epochs):
    """The JAX fits' own draws (train/loop.py:341-342, 508-509 and
    :722-724, 996-997): one init, then one permutation per epoch."""
    key, ik = jax.random.split(key)
    jp = jinit(ik, dim_in, C, jspec, pad_input_to=128)
    perms = []
    for _ in range(epochs):
        key, pk = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(pk, n_g)))
    return jp, perms


H = W = 64
CH, EPOCHS, BS, G = 4, 2, 1024, 8  # 512 granules of 8 px: 4 steps an epoch


def _fit_specs():
    return (JTrainSpec(batch_size=BS, epochs=EPOCHS, sample_granule=G),
            TrainSpec(batch_size=BS, epochs=EPOCHS, sample_granule=G))


def _assert_fit_matches(got, ref):
    assert got.step_losses.shape == ref.step_losses.shape
    np.testing.assert_allclose(got.epoch_losses.numpy(), np.asarray(ref.epoch_losses), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.best_mse), np.asarray(ref.best_mse), rtol=1e-5)
    assert np.array_equal(np.asarray(got.best_epoch), np.asarray(ref.best_epoch))


def _assert_same_fit(a, b):
    assert torch.equal(a.step_losses, b.step_losses)
    assert a.best_epoch == b.best_epoch and a.best_mse == b.best_mse
    assert all(torch.equal(x, y) for x, y in zip(a.params.leaves(), b.params.leaves()))


def test_fit_multi_k_matches_jax():
    """`fit(multi_k=3)` on 64x64x4 (bs 1024, e=2: one 3-step chunk and a
    1-step remainder an epoch) vs the JAX chunked fit in interpret mode,
    the JAX init and permutations injected; and bit for bit the port's
    per-step fit."""
    img = synth_scene(H, W, channels=CH, effective_bits=12, seed=3)
    jmsb, jlsb = jeng.split_msb_lsb(jnp.asarray(img), K)
    jplane, jscale = jeng.pad_plane(jmsb, 2)
    msb, lsb = engine.split_msb_lsb(torch.from_numpy(img.astype(np.int32)), K)
    plane, scale = engine.pad_plane(msb, 2)
    jt, t = _fit_specs()
    label_scale = np.float32(jeng.lsb_scale(K))
    key = jax.random.PRNGKey(11)
    with pltpu.force_tpu_interpret_mode():
        ref = jloop.fit(jplane, jscale, jlsb.astype(jnp.uint16), label_scale, key,
                        JFeatureSpec(), JModelSpec(), jt, H, W, CH, staging="cached",
                        use_fused=True, multi_k=3)
    jp, perms = _jax_draws(key, H * W // G, 100, CH, JModelSpec(), EPOCHS)
    init = params_from_numpy([np.asarray(w) for w in jp.weights],
                             [np.asarray(b) for b in jp.biases])
    run = lambda k: loop.fit(plane, scale, lsb, float(label_scale), None, FeatureSpec(),
                             ModelSpec(), t, H, W, CH, use_fused=True, multi_k=k, init=init,
                             perms=perms, device="cpu")
    got = run(3)
    _assert_fit_matches(got, ref)
    _assert_same_fit(got, run(None))


def test_fit_rate_experts_multi_k_matches_jax():
    """`fit_rate_experts(multi_k=3)` at K in (3, 5, 6) on the same shape
    vs the JAX chunked expert fit ("full" staging) in interpret mode; and
    bit for bit the port's per-step expert fit."""
    Ks = (3, 5, 6)
    img = synth_scene(H, W, channels=CH, effective_bits=12, seed=3)
    jt, t = _fit_specs()
    key = jax.random.PRNGKey(11)
    mx = int(img.max())
    jdts = tuple(jnp.dtype(jeng.tap_matrix_dtype(mx >> k, True)).name for k in Ks)
    with pltpu.force_tpu_interpret_mode():
        ref = jloop.fit_rate_experts(jnp.asarray(img), Ks, key, JFeatureSpec(), JModelSpec(),
                                     jt, H, W, CH, jdts, use_fused=True, staging="full",
                                     multi_k=3)
    jp, perms = _jax_draws(key, H * W // G, 100, CH, JModelSpec(), EPOCHS)
    init = params_from_numpy([np.asarray(w) for w in jp.weights],
                             [np.asarray(b) for b in jp.biases])
    run = lambda k: loop.fit_rate_experts(torch.from_numpy(img.astype(np.int32)), Ks, None,
                                          FeatureSpec(), ModelSpec(), t, H, W, CH,
                                          use_fused=True, multi_k=k, init=init, perms=perms,
                                          device="cpu")
    got = run(3)
    _assert_fit_matches(got, ref)
    _assert_same_fit(got, run(0))


@pytest.mark.parametrize("P", [1, 2, 12676, 12677, 50568])
def test_scratch_stride(P):
    """A partial row holds P gradients, the SSE and the mask count, padded
    to 16 bytes, so every row of the (E, tiles, S) scratch that K1-K4 share
    starts 16-byte aligned."""
    S = fs.scratch_stride(P)
    assert S >= P + 2 and S % 4 == 0 and S - (P + 2) < 4


def test_launcher_checks():
    """The launchers' leaf check passes a contiguous f32 tensor of the shape
    and names the leaf (a tuple of parts, joined only then) when it
    refuses one."""
    dev = torch.device("cpu")
    w = torch.zeros(3, 4)
    fs._check(w, (3, 4), ("m", "weight", 1), dev)
    fs._check(w, torch.Size([3, 4]), "x", dev)
    for bad, shape, msg in ((w, (4, 3), "m weight 1: expected shape"),
                            (w.double(), (3, 4), "m weight 1: expected float32"),
                            (w.t(), (4, 3), "m weight 1: must be contiguous")):
        with pytest.raises(ValueError, match=msg):
            fs._check(bad, shape, ("m", "weight", 1), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("E,bc,nl,dim_out,B,k", [(None, 64, 2, 4, 8192, 16),
                                                 (None, 128, 3, 8, 1000, 4),
                                                 (4, 64, 2, 4, 8192 - 37, 8),
                                                 (4, 128, 3, 8, 1000, 4)])
def test_multi_step_is_chained_steps_on_card(E, bc, nl, dim_out, B, k):
    """On the card, one K3 launch is k chained K1 launches and one K4
    launch k chained K2 launches (shared mask), bit for bit, each counted
    once (chip_smoke.py runs the same checks at the bench shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    spec = ModelSpec(bc, nl)
    ws, bs, X, Y, masks = _setup(bc, nl, 100, dim_out, B, k, E=E, seed=13)
    lrs = [1e-3 * 0.5 ** (s % 3) for s in range(k)]
    multi, chained = _state(ws, bs, dev), _state(ws, bs, dev)
    Xt, Yt, Mt = (torch.from_numpy(a).to(dev) for a in (X, Y, masks))
    kern, single = ((fs.fused_multi_step, fs.fused_train_step) if E is None else
                    (fs.fused_expert_multi_step, fs.fused_expert_step))
    n_multi, n_single = kern.launches, single.launches
    *_, lm = kern(*multi, Xt, Yt, Mt, lrs, 2, spec, dim_out)
    lc = torch.empty_like(lm)
    for s in range(k):
        single(*chained, Xt[s], Yt[s], Mt[s], lrs[s], 2 + s, spec, dim_out, loss_out=lc[s])
    torch.cuda.synchronize()
    assert torch.equal(lm, lc)
    assert _same(multi, chained)
    assert kern.launches == n_multi + 1 and single.launches == n_single + k
