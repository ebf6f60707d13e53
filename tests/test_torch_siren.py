"""Port SIREN model vs the JAX package's (same numpy-seeded inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbdrn_msic_tpu.core.config import ModelSpec as JModelSpec
from lbdrn_msic_tpu.models import siren as jsiren
from lbdrn_msic_tpu_torch.core.config import ModelSpec
from lbdrn_msic_tpu_torch.models import siren


def _jax_params(seed, dim_in, dim_out, spec):
    p = jsiren.init_params(jax.random.PRNGKey(seed), dim_in, dim_out, spec)
    return [np.asarray(w) for w in p.weights], [np.asarray(b) for b in p.biases], p


SPECS = [(64, 2, 100, 4), (32, 1, 36, 2), (128, 3, 100, 8)]


@pytest.mark.parametrize("bc,nl,dim_in,dim_out", SPECS)
def test_params_from_numpy_round_trip(bc, nl, dim_in, dim_out):
    ws, bs, _ = _jax_params(0, dim_in, dim_out, JModelSpec(bc, nl))
    p = siren.params_from_numpy(ws, bs)
    ws2, bs2 = siren.params_to_numpy(p)
    for a, b in zip(ws + bs, ws2 + bs2):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fast_act", [False, True])
@pytest.mark.parametrize("bc,nl,dim_in,dim_out", SPECS)
def test_forward_matches_jax(bc, nl, dim_in, dim_out, fast_act):
    jspec, spec = JModelSpec(bc, nl), ModelSpec(bc, nl)
    ws, bs, jp = _jax_params(1, dim_in, dim_out, jspec)
    rng = np.random.default_rng(2)
    x = np.zeros((512, ws[0].shape[0]), np.float32)
    x[:, :dim_in] = rng.uniform(-1, 1, (512, dim_in))
    ref = np.asarray(jsiren.forward(jp, jnp.asarray(x), jspec, fast_act=fast_act))
    got = siren.forward(siren.params_from_numpy(ws, bs), torch.from_numpy(x), spec,
                        fast_act=fast_act).numpy()
    # f32 matmuls in different summation orders, then sin/sigmoid
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bc,nl,dim_in,dim_out", SPECS)
def test_flatten_byte_identical(bc, nl, dim_in, dim_out):
    ws, bs, jp = _jax_params(3, dim_in, dim_out, JModelSpec(bc, nl))
    ref = jsiren.flatten_params(jp, dim_in)
    got = siren.flatten_params(siren.params_from_numpy(ws, bs), dim_in)
    assert got.dtype == np.float32
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("bc,nl,dim_in,dim_out", SPECS)
def test_unflatten_round_trip(bc, nl, dim_in, dim_out):
    spec = ModelSpec(bc, nl)
    p = siren.init_params(torch.Generator().manual_seed(4), dim_in, dim_out, spec)
    flat = siren.flatten_params(p, dim_in)
    assert flat.size == spec.param_count(dim_in, dim_out)
    back = siren.unflatten_params(flat, dim_in, dim_out, spec)
    for a, b in zip(p.leaves(), back.leaves()):
        assert torch.equal(a, b)
    # the JAX package reads the same vector into the same arrays
    jp = jsiren.unflatten_params(flat, dim_in, dim_out, JModelSpec(bc, nl))
    for a, b in zip(p.leaves(), jp.weights + jp.biases):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        siren.unflatten_params(flat[:-1], dim_in, dim_out, spec)


def test_init_scheme():
    spec = ModelSpec()
    p = siren.init_params(torch.Generator().manual_seed(0), 100, 4, spec)
    assert [tuple(w.shape) for w in p.weights] == [(128, 64), (64, 64), (64, 4)]
    assert torch.all(p.weights[0][100:] == 0)
    assert float(p.weights[0].abs().max()) <= 1 / 100
    s = float(np.sqrt(spec.c / 64) / spec.w0)
    assert float(p.weights[1].abs().max()) <= s and float(p.biases[2].abs().max()) <= s
    q = siren.init_params(torch.Generator().manual_seed(0), 100, 4, spec)
    assert all(torch.equal(a, b) for a, b in zip(p.leaves(), q.leaves()))
