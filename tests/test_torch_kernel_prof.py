"""K5, the step-anatomy probes (lbdrn_msic_tpu_torch/profiling/kernel_prof.py)
vs the JAX script's kernel body (scripts/profiling/kernel_prof.py
`make_kernel`, loaded by path), run in interpret mode two steps at a time.

The JAX script only runs its 512-step scan (about 60 s a variant in
interpret mode, and the variants drift far apart over 512 steps), so a
test-local one-step `pallas_call` copies its spec wiring (kernel_prof.py:
223-267) and the port's plain `variant_step` is held against two chained
steps at B=256.  Tolerances by product, from zero Adam state with
c1 = c2 = 1 (every update is ~3.2 lr * sign(m) wherever |g| >> 1e-8, so a
last-bit difference flips near-zero gradients' updates; step 2 amplifies
step 1's differences through w0 = 30):
- f32 (prod_f32, full_t, full_dg, fast_full, tile2048, fwd_notrans): loss
  rtol 1e-5; m, v within 1e-4 (step 1) / 1e-3 (step 2) of the largest;
- 3xTF32 (prec_high) against JAX's f32 (the CPU ignores lax.Precision):
  loss rtol 1e-5 / 1e-4, m, v 1e-3 / 1e-2;
- bf16 (prod_bf16, both sides bf16): a flipped bf16 rounding moves a term
  by 2^-8, so loss rtol 1e-4 / 1e-3 and m, v at the bf16 gradient tier of
  tests/test_fused_step.py:166 (2e-2 of the largest);
- TF32 (prec_default) against JAX's f32: one-pass TF32 is ~1e-3 relative on
  each product, which w0 = 30 makes a few per cent of the gradient; loss
  rtol 1e-3 / 5e-2, m, v within 1e-1 of the largest after step 1, not
  compared after step 2;
params within 1e-3 for f32 and 3xTF32 and within the Adam update bound
(2 * (3.17 + 4.26) lr over two steps) for TF32 and bf16.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lbdrn_msic_tpu_torch.models.siren import params_from_numpy
from lbdrn_msic_tpu_torch.profiling import kernel_prof as kp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_kernel_prof", os.path.join(REPO, "scripts", "profiling", "kernel_prof.py"))
jkp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jkp)

BT, L, C = 256, 3, 4
# per product: (loss rtol, m/v fraction of the largest) after step 1 and 2
TIERS = {"f32": ((1e-5, 1e-4), (1e-5, 1e-3)), "3xtf32": ((1e-5, 1e-3), (1e-4, 1e-2)),
         "bf16": ((1e-4, 2e-2), (1e-3, 2e-2)), "tf32": ((1e-3, 1e-1), (5e-2, None))}
# the largest Adam update with c1 = c2 = 1 from zero state, in units of lr:
# |m| / sqrt(v) at step 1 and (Cauchy-Schwarz) at step 2
ADAM_BOUND = (np.sqrt(0.1 ** 2 / 0.001), np.sqrt(0.09 ** 2 / 0.000999 + 0.1 ** 2 / 0.001))


@functools.partial(jax.jit, static_argnames=("mode", "use_dg", "tile"))
def _jax_step(state, x, y, mask, mode, use_dg, tile):
    """One step of the JAX script's kernel: its `one_step` body
    (kernel_prof.py:229-267) for a batch of any size, tile rows per grid
    step.  state: (ws, bs, mws, vws, mbs, vbs), biases (1, out)."""
    ws, bs_, mws, vws, mbs, vbs = state
    full = lambda a: pl.BlockSpec(a.shape, lambda t: tuple(0 for _ in a.shape),
                                  memory_space=pltpu.VMEM)
    tile_spec = lambda width: pl.BlockSpec((tile, width), lambda t: (t, 0),
                                           memory_space=pltpu.VMEM)
    scalars = jnp.stack([jnp.float32(1e-3), jnp.float32(1.0), jnp.float32(1.0),
                         jnp.float32(1.0 / (x.shape[0] * C))]).reshape(1, 4)
    leaves = ws + bs_ + mws + vws + mbs + vbs
    outs = pl.pallas_call(
        jkp.make_kernel(mode, use_dg),
        grid=(x.shape[0] // tile,),
        in_specs=([pl.BlockSpec((1, 4), lambda t: (0, 0), memory_space=pltpu.SMEM)]
                  + [tile_spec(x.shape[1]), tile_spec(C), tile_spec(1)]
                  + [full(a) for a in leaves]),
        out_shape=([jax.ShapeDtypeStruct(a.shape, a.dtype) for a in leaves]
                   + [jax.ShapeDtypeStruct((1, 1), jnp.float32)]),
        out_specs=[full(a) for a in leaves] + [pl.BlockSpec((1, 1), lambda t: (0, 0),
                                                            memory_space=pltpu.VMEM)],
        scratch_shapes=([pltpu.VMEM(a.shape, jnp.float32) for a in ws]
                        + [pltpu.VMEM(b.shape, jnp.float32) for b in bs_]
                        + [pltpu.VMEM((1, 1), jnp.float32)]),
        input_output_aliases={4 + i: i for i in range(6 * L)},
    )(scalars, x, y, mask, *leaves)
    return tuple(list(outs[i * L:(i + 1) * L]) for i in range(6)), outs[6 * L].reshape(())


def _inputs(seed=0):
    """The JAX script's shapes and scales (kernel_prof.py:274-289) at B=256,
    from numpy: weights N(0, 1) * 0.05, zero biases, x ~ U(-1, 1),
    y ~ U(0, 1), a mask of ones."""
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32)
          for s in ((kp.F, kp.BC), (kp.BC, kp.BC), (kp.BC, C))]
    bs = [np.zeros(kp.BC, np.float32), np.zeros(kp.BC, np.float32), np.zeros(C, np.float32)]
    x = rng.uniform(-1, 1, (BT, kp.F)).astype(np.float32)
    y = rng.uniform(0, 1, (BT, C)).astype(np.float32)
    return ws, bs, x, y, np.ones(BT, np.float32)


def _port_state(ws, bs):
    p = params_from_numpy(ws, bs)
    return p, p.map(torch.zeros_like), p.map(torch.zeros_like)


def _jax_leaves(state, which):
    """params / m / v of a JAX state as numpy arrays in the port's leaf
    order (weights, then biases (out,))."""
    w, b = {"p": (0, 1), "m": (2, 4), "v": (3, 5)}[which]
    return [np.asarray(a) for a in state[w]] + [np.asarray(a).reshape(-1) for a in state[b]]


@pytest.mark.parametrize("variant", list(kp.VARIANTS))
def test_variant_matches_jax_kernel(variant):
    mode, use_dg, tile = kp.VARIANTS[variant]
    product = kp.PRODUCT.get(mode, "f32")
    ws, bs, x, y, mask = _inputs()
    jstate = ([jnp.asarray(w) for w in ws], [jnp.asarray(b).reshape(1, -1) for b in bs],
              *([jnp.zeros(w.shape, jnp.float32) for w in ws] for _ in range(2)),
              *([jnp.zeros((1, b.size), jnp.float32) for b in bs] for _ in range(2)))
    port = _port_state(ws, bs)
    xt, yt, mt = map(torch.from_numpy, (x, y, mask))
    bound = 0.0
    for step, (loss_rtol, mv_frac) in enumerate(TIERS[product]):
        with pltpu.force_tpu_interpret_mode():
            jstate, jloss = _jax_step(jstate, jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(mask).reshape(-1, 1), mode, use_dg,
                                      tile * BT // kp.B)
        loss = kp.variant_step_plain(*port, xt, yt, mt, variant)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=loss_rtol)
        for st, which in ((port[1], "m"), (port[2], "v")) if mv_frac is not None else ():
            want = _jax_leaves(jstate, which)
            scale = max(float(np.abs(a).max()) for a in want)
            for a, b in zip(st.leaves(), want):
                np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=mv_frac * scale)
        bound += 2 * ADAM_BOUND[step] * kp.LR
        for a, b in zip(port[0].leaves(), _jax_leaves(jstate, "p")):
            atol = 1e-3 if product in ("f32", "3xtf32") else bound
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol)
    if mode == "fwd_notrans":  # forward only: params, m and v untouched
        for a, b in zip(port[0].leaves(), ws + bs):
            np.testing.assert_array_equal(a.numpy(), b)
        assert all(float(t.abs().max()) == 0.0 for t in port[1].leaves() + port[2].leaves())


def test_run_steps_is_chained_plain_steps():
    """`run_steps(steps=n)` on the CPU is n chained `variant_step_plain`
    calls bit for bit, for a variant of each kind (K1's, a probe, the
    forward-only one), and sums its per-step losses."""
    ws, bs, x, y, mask = _inputs(seed=1)
    wt, bt = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    xt, yt, mt = map(torch.from_numpy, (x, y, mask))
    for variant in ("prod_bf16", "prec_high", "fwd_notrans"):
        total, losses = kp.run_steps(wt, bt, xt, yt, mt.reshape(-1, 1), variant, steps=3,
                                     device="cpu")
        state = _port_state(ws, bs)
        chained = [float(kp.variant_step_plain(*state, xt, yt, mt, variant)) for _ in range(3)]
        assert losses.tolist() == chained
        assert float(total) == float(losses.sum())


def test_tile2048_is_full_dg_and_tf32_rounding():
    """tile2048 and full_dg are one function (the plain versions agree bit
    for bit; on the card they differ in rows per CTA only); TF32 rounding
    keeps 10 mantissa bits, ties away from zero, as cvt.rna.tf32.f32."""
    ws, bs, x, y, mask = _inputs(seed=2)
    a, b = _port_state(ws, bs), _port_state(ws, bs)
    args = tuple(map(torch.from_numpy, (x, y, mask)))
    assert float(kp.variant_step_plain(*a, *args, "tile2048")) == float(
        kp.variant_step_plain(*b, *args, "full_dg"))
    assert all(torch.equal(s, t) for p, q in zip(a, b) for s, t in zip(p.leaves(), q.leaves()))
    assert kp.cta_rows("tile2048") * 4 == kp.cta_rows("full_dg")

    one = 1.0 + 2.0 ** -11  # halfway between two TF32 values
    v = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0, 1.0 + 3 * 2.0 ** -11])
    assert kp.tf32_round(v).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0,
                                         1.0 + 2 * 2.0 ** -10]
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(1000).astype(np.float32))
    assert float(((kp.tf32_round(r) - r).abs() / r.abs()).max()) <= 2.0 ** -11


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(kp.VARIANTS))
def test_variant_kernel_matches_plain_on_card(variant):
    """Each variant's kernel vs its plain version on the card at the bench
    shape, one step from the same state (chip_smoke.py's kernel_prof phase
    runs the same checks and a 5-step chain)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ws, bs, x, y, mask = kp.make_inputs(device="cuda")
    k = params_from_numpy([w.cpu().numpy() for w in ws], [b.cpu().numpy() for b in bs], "cuda")
    p = params_from_numpy([w.cpu().numpy() for w in ws], [b.cpu().numpy() for b in bs], "cuda")
    kst = (k, k.map(torch.zeros_like), k.map(torch.zeros_like))
    pst = (p, p.map(torch.zeros_like), p.map(torch.zeros_like))
    kl = kp.variant_step(*kst, x, y, mask, variant)
    pl_ = kp.variant_step_plain(*pst, x, y, mask, variant)
    torch.cuda.synchronize()
    rtol = 1e-3 if kp.PRODUCT.get(kp.VARIANTS[variant][0]) in ("tf32", "bf16") else 1e-5
    np.testing.assert_allclose(float(kl), float(pl_), rtol=rtol)
