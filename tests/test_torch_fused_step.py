"""Port fused training step vs the JAX package's (Pallas kernel in
interpret mode, and its pure-JAX oracles), on numpy-seeded inputs.

Tiers, as in tests/test_fused_step.py:
- the kernel's function (`fused_train_step` on CPU tensors, i.e. its plain
  version) vs the JAX kernel and vs `reference_train_step(match_kernel=True)`
  at the tight tolerances of tests/test_fused_step.py:61-67 (only
  summation order differs);
- a chain of steps vs the exact `sin` + autodiff oracle at the trajectory
  tolerance of tests/test_fused_step.py:94.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from lbdrn_msic_tpu.core.config import ModelSpec as JModelSpec
from lbdrn_msic_tpu.models.siren import SirenParams as JParams
from lbdrn_msic_tpu.models.siren import init_params as jinit
from lbdrn_msic_tpu.ops import fused_step as jfs
from lbdrn_msic_tpu_torch.core.config import ModelSpec
from lbdrn_msic_tpu_torch.models.siren import params_from_numpy
from lbdrn_msic_tpu_torch.ops import fused_step as fs

TILE = 1024


def _setup(bc, nl, dim_in, dim_out, B, seed=0, mask_frac=0.0):
    jp = jinit(jax.random.PRNGKey(seed), dim_in, dim_out, JModelSpec(bc, nl))
    ws = [np.asarray(w) for w in jp.weights]
    bs = [np.asarray(b) for b in jp.biases]
    rng = np.random.default_rng(seed + 1)
    x = (rng.standard_normal((B, ws[0].shape[0])) * 0.1).astype(np.float32)
    y = (1 / (1 + np.exp(-rng.standard_normal((B, dim_out))))).astype(np.float32)
    mask = (rng.random(B) >= mask_frac).astype(np.float32)
    return ws, bs, x, y, mask


def _port_state(ws, bs):
    p = params_from_numpy(ws, bs)
    return p, p.map(torch.zeros_like), p.map(torch.zeros_like)


def _jax_state(ws, bs):
    p = JParams([jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    z = jax.tree.map(jnp.zeros_like, p)
    return p, z, z


def _leaves(p):
    if isinstance(p, JParams):
        return [np.asarray(a) for a in list(p.weights) + list(p.biases)]
    return [a.numpy() for a in p.leaves()]


def _assert_step_close(port, ref, loss, ref_loss):
    """tests/test_fused_step.py:61-67 tolerances, for one step from zero
    Adam state.  The step moves a param by ~lr*g/(|g|+eps), whose
    sensitivity to g is lr*eps/(|g|+eps)^2: for |g| < 1e-6 a last-bit
    difference in the gradient sum (summation order) moves it by up to
    2*lr.  The gradient itself is held tightly through m = (1-b1)*g and v;
    params are held at the tests' tolerance where |g| >= 1e-6 and within
    2*lr elsewhere."""
    pp, pm, pv = port
    rp, rm, rv = ref
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for a, b in zip(_leaves(pm) + _leaves(pv), _leaves(rm) + _leaves(rv)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-10)
    for a, b, m in zip(_leaves(pp), _leaves(rp), _leaves(rm)):
        well = np.abs(m) / (1 - fs.ADAM_B1) >= 1e-6
        np.testing.assert_allclose(a[well], b[well], rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)


@pytest.mark.parametrize(
    "bound,tol", [(3.0, 4e-7), (40.0, 4e-6), (1000.0, 1e-4)]
)
def test_sincos_matches_jax_and_f64(bound, tol):
    u = np.random.default_rng(3).uniform(-bound, bound, 100_000).astype(np.float32)
    s, c = fs.sincos(torch.from_numpy(u))
    js, jc = jax.jit(jfs.sincos)(jnp.asarray(u))
    # same constants and operation order: equal up to the last bit or two
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=2e-7 * bound)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=2e-7 * bound)
    np.testing.assert_allclose(s.numpy(), np.sin(u.astype(np.float64)), atol=tol)
    np.testing.assert_allclose(c.numpy(), np.cos(u.astype(np.float64)), atol=tol)


@pytest.mark.parametrize(
    "bc,nl,dim_in,dim_out", [(64, 2, 100, 4), (32, 1, 36, 2), (128, 3, 100, 8)]
)
def test_step_matches_jax_kernel_and_oracle(bc, nl, dim_in, dim_out):
    B = 2 * TILE
    ws, bs, x, y, mask = _setup(bc, nl, dim_in, dim_out, B)
    jspec, spec = JModelSpec(bc, nl), ModelSpec(bc, nl)
    lr, step = np.float32(1e-3), np.int32(1)

    with pltpu.force_tpu_interpret_mode():
        jout = jfs.fused_train_step(*_jax_state(ws, bs), jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(mask), lr, step, jspec, dim_out, tile=TILE)
    port = _port_state(ws, bs)
    *_, loss = fs.fused_train_step(*port, torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(mask), 1e-3, 1, spec, dim_out)
    _assert_step_close(port, jout[:3], loss, jout[3])

    oracle = _port_state(ws, bs)
    *_, oloss = fs.reference_train_step(*oracle, torch.from_numpy(x), torch.from_numpy(y),
                                        torch.from_numpy(mask), 1e-3, 1, spec, dim_out,
                                        match_kernel=True)
    _assert_step_close(port, oracle, loss, oloss)


def _assert_bf16_step_close(port, ref, loss, ref_loss, n_steps=1, lr=1e-3):
    """Steps at mm_dtype "bfloat16" vs the JAX kernel's: both round the same
    operands to bf16, but a last-bit f32 difference upstream (summation
    order) can flip an operand's bf16 rounding (2^-8 relative), so m and v
    are held at the bf16 gradient tier of tests/test_fused_step.py:166
    (2e-2 of the largest), the loss at rtol 1e-4, and params tightly only
    where |g| is above that noise (within 2*lr a step elsewhere)."""
    pp, pm, pv = port
    rp, rm, rv = ref
    np.testing.assert_allclose(np.asarray(loss).reshape(-1), np.asarray(ref_loss).reshape(-1),
                               rtol=1e-4)
    for got, want in ((_leaves(pm), _leaves(rm)), (_leaves(pv), _leaves(rv))):
        scale = max(float(np.abs(b).max()) for b in want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-2 * scale)
    gscale = max(float(np.abs(m).max()) for m in _leaves(rm))
    for a, b, m in zip(_leaves(pp), _leaves(rp), _leaves(rm)):
        well = np.abs(m) >= 2e-2 * gscale
        np.testing.assert_allclose(a[well], b[well], rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr * n_steps)


def test_step_bf16_matches_jax_kernel():
    """K1's function at mm_dtype "bfloat16" vs the JAX kernel at
    mm_dtype="bfloat16" in interpret mode (bench widths), and the port's
    match_kernel oracle with the same casts vs the JAX one."""
    ws, bs, x, y, mask = _setup(64, 2, 100, 4, 2 * TILE, seed=3, mask_frac=0.2)
    jspec, spec = JModelSpec(), ModelSpec()
    xt, yt, mt = map(torch.from_numpy, (x, y, mask))
    with pltpu.force_tpu_interpret_mode():
        jout = jfs.fused_train_step(*_jax_state(ws, bs), jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(mask), np.float32(1e-3), np.int32(1), jspec, 4,
                                    tile=TILE, mm_dtype="bfloat16")
    port = _port_state(ws, bs)
    *_, loss = fs.fused_train_step(*port, xt, yt, mt, 1e-3, 1, spec, 4, mm_dtype="bfloat16")
    _assert_bf16_step_close(port, jout[:3], loss, jout[3])

    jref = jfs.reference_train_step(*_jax_state(ws, bs), jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(mask), np.float32(1e-3), np.int32(1), jspec, 4,
                                    match_kernel=True, mm_dtype="bfloat16")
    oracle = _port_state(ws, bs)
    *_, oloss = fs.reference_train_step(*oracle, xt, yt, mt, 1e-3, 1, spec, 4,
                                        match_kernel=True, mm_dtype="bfloat16")
    _assert_bf16_step_close(oracle, jref[:3], oloss, jref[3])


def test_mm_dtype_none_is_the_f32_step():
    """mm_dtype=None is the default, f32 step bit for bit (so every other
    test's numbers are those of the f32 kernel); "bfloat16" is a different
    step; any other value raises."""
    ws, bs, x, y, mask = _setup(64, 2, 100, 4, 512, seed=4, mask_frac=0.1)
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask), 1e-3, 1,
            ModelSpec(), 4)
    default, none, bf16 = _port_state(ws, bs), _port_state(ws, bs), _port_state(ws, bs)
    *_, l_default = fs.fused_train_step(*default, *args)
    *_, l_none = fs.fused_train_step(*none, *args, mm_dtype=None)
    *_, l_bf16 = fs.fused_train_step(*bf16, *args, mm_dtype="bfloat16")
    assert float(l_default) == float(l_none) != float(l_bf16)
    for a, b in zip(_leaves(default[0]) + _leaves(default[1]), _leaves(none[0]) + _leaves(none[1])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="mm_dtype"):
        fs.fused_train_step(*_port_state(ws, bs), *args, mm_dtype="float16")


@pytest.mark.parametrize(
    "B,mask_frac", [(1000, 0.0), (2048, 0.3), (777, 0.5), (300, 1.0)]
)
def test_ragged_and_masked_batches(B, mask_frac):
    """Any batch size (the kernel masks its last CTA's rows itself) and any
    mask, against the JAX match_kernel oracle; an all-zero mask leaves the
    params unchanged and the loss 0 (count clamped at 1)."""
    ws, bs, x, y, mask = _setup(64, 2, 100, 4, B, seed=7, mask_frac=mask_frac)
    jspec, spec = JModelSpec(), ModelSpec()
    jout = jfs.reference_train_step(*_jax_state(ws, bs), jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(mask), np.float32(1e-3), np.int32(1),
                                    jspec, 4, match_kernel=True)
    port = _port_state(ws, bs)
    *_, loss = fs.fused_train_step(*port, torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(mask), 1e-3, 1, spec, 4)
    _assert_step_close(port, jout[:3], loss, jout[3])
    if mask_frac == 1.0:
        assert float(loss) == 0.0
        for a, b in zip(_leaves(port[0]), ws + bs):
            np.testing.assert_array_equal(a, b)


def test_chain_tracks_exact_oracle():
    """5 chained steps: the kernel's function vs the exact sin + autograd
    oracle at loss rtol 2e-4 (tests/test_fused_step.py:94), and vs the JAX
    exact oracle; params within 2*lr per step (near-zero-gradient sign
    flips under the polynomial sincos)."""
    ws, bs, x, y, mask = _setup(32, 2, 36, 2, TILE, seed=5)
    jspec, spec = JModelSpec(32, 2), ModelSpec(32, 2)
    xt, yt, mt = map(torch.from_numpy, (x, y, mask))
    port, exact = _port_state(ws, bs), _port_state(ws, bs)
    jstate = _jax_state(ws, bs)
    n_steps = 5
    for t in range(1, n_steps + 1):
        *_, fl = fs.fused_train_step(*port, xt, yt, mt, 1e-3, t, spec, 2)
        *_, el = fs.reference_train_step(*exact, xt, yt, mt, 1e-3, t, spec, 2)
        *jstate, jl = jfs.reference_train_step(*jstate, jnp.asarray(x), jnp.asarray(y),
                                               jnp.asarray(mask), np.float32(1e-3),
                                               np.int32(t), jspec, 2)
        np.testing.assert_allclose(float(fl), float(el), rtol=2e-4)
        np.testing.assert_allclose(float(el), float(jl), rtol=2e-4)
    for a, b in zip(_leaves(port[0]), _leaves(exact[0])):
        np.testing.assert_allclose(a, b, atol=2e-3 * n_steps)
    for a, b in zip(_leaves(exact[0]), _leaves(jstate[0])):
        np.testing.assert_allclose(a, b, atol=2e-3 * n_steps)


def test_bias_corrections_and_loss_out():
    c1, c2 = fs.bias_corrections(1)
    assert np.float32(c1) == np.float32(1) / (np.float32(1) - np.float32(0.9))
    assert c2 > c1 > 1
    ws, bs, x, y, mask = _setup(64, 2, 100, 4, 256, seed=9)
    buf = torch.zeros(3)
    *_, loss = fs.fused_train_step(*_port_state(ws, bs), torch.from_numpy(x),
                                   torch.from_numpy(y), torch.from_numpy(mask),
                                   1e-3, 1, ModelSpec(), 4, loss_out=buf[1])
    assert float(buf[1]) == float(loss) > 0 and float(buf[0]) == 0.0


# H100's opt-in shared memory per block (227 KB)
H100_SMEM_OPTIN = 232448


@pytest.mark.parametrize(
    "bc,nl,C,rows,staged",
    [(64, 2, 4, 64, True), (32, 1, 2, 64, True), (128, 3, 8, 32, False)],
)
def test_cta_layout(bc, nl, C, rows, staged):
    """Rows per CTA and weight staging as the wrapper picks them on an
    H100: the bench widths stage everything at 64 rows; bc=128, nl=3 has
    200 KB of weights, which leave no room for even 8 rows, so the kernel
    reads them from global memory."""
    dims = [128] + [bc] * nl + [C]
    assert fs.cta_layout(dims, H100_SMEM_OPTIN) == (rows, staged)
    assert fs.smem_bytes(dims, rows, staged) <= H100_SMEM_OPTIN
    if rows < fs.ROWS:
        assert fs.smem_bytes(dims, 2 * rows, staged) > H100_SMEM_OPTIN
    with pytest.raises(ValueError):
        fs.cta_layout(dims, fs.smem_bytes(dims, 8, False) - 4)


@pytest.mark.cuda
@pytest.mark.parametrize("bc,nl,dim_out,B", [(64, 2, 4, 8192 - 37), (128, 3, 8, 1000)])
def test_kernel_matches_plain_on_card(bc, nl, dim_out, B):
    """The CUDA kernel vs its plain version on the card, at the bench widths
    and at a layer set whose weights stay in global memory (chip_smoke.py
    runs the same checks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ws, bs, x, y, mask = _setup(bc, nl, 100, dim_out, B, seed=11, mask_frac=0.2)
    spec = ModelSpec(bc, nl)
    dev = torch.device("cuda")
    kp = params_from_numpy(ws, bs, dev)
    kstate = (kp, kp.map(torch.zeros_like), kp.map(torch.zeros_like))
    pp = params_from_numpy(ws, bs, dev)
    pstate = (pp, pp.map(torch.zeros_like), pp.map(torch.zeros_like))
    xt, yt, mt = (torch.from_numpy(a).to(dev) for a in (x, y, mask))
    n0 = fs.fused_train_step.launches
    *_, kl = fs.fused_train_step(*kstate, xt, yt, mt, 1e-3, 1, spec, dim_out)
    *_, pl = fs.fused_train_step_plain(*pstate, xt, yt, mt, 1e-3, 1, spec, dim_out)
    torch.cuda.synchronize()
    assert fs.fused_train_step.launches == n0 + 1
    np.testing.assert_allclose(float(kl), float(pl), rtol=1e-5)
    for a, b in zip(kstate[1].leaves() + kstate[2].leaves(),
                    pstate[1].leaves() + pstate[2].leaves()):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-3, atol=1e-10)
