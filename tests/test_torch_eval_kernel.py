"""The fast-act eval's row blocks through `fused_eval_sse` (kernel K6 on the
card, its plain version on the CPU), on numpy-seeded inputs.

CPU: `blocks_mse(fast_act=True)` against the block path it replaced (the
forward, the squared error and the live region's sum, block by block),
bit for bit, at both cells' shapes (C = 4 at F_pad 128, dim_in 100; C = 8 at
F_pad 256, dim_in 200), with a clamped last block, a bucket's real shape,
the eval over half the scene and an expert's views; the plain version's live
region against a numpy sum; K6's shared-memory layout.  Card (`cuda`, skipped
without one; this file imports no JAX, so it runs there as it is): K6
against the plain version, its bits repeated, and its launches in `fit` and
`fit_rate_experts`.
"""

import numpy as np
import pytest
import torch

from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.features import engine
from lbdrn_msic_tpu_torch.models.siren import (
    forward,
    init_params,
    pad_dim,
    stack_params,
    unstack_params,
)
from lbdrn_msic_tpu_torch.ops import fused_step as fs
from lbdrn_msic_tpu_torch.train import loop
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

# (C, dim_in): the pms4 cells' and the wfi8 cells' eval widths
SHAPES = [(4, 100), (8, 200)]
H100_SMEM_OPTIN = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100


def _params(C, dim_in, seed=0, spec=ModelSpec(), device=None):
    return init_params(torch.Generator().manual_seed(seed), dim_in, C, spec,
                       pad_input_to=pad_dim(dim_in), device=device)


def _scene(H, W, C, dim_in, seed=1, device=None):
    """(H * W, F_pad) inputs, zero past dim_in as the feature cache holds
    them, and (H * W, C) labels in [0, 1]."""
    rng = np.random.default_rng(seed)
    x = np.zeros((H * W, pad_dim(dim_in)), np.float32)
    x[:, :dim_in] = rng.uniform(-1, 1, (H * W, dim_in))
    y = rng.uniform(0, 1, (H * W, C)).astype(np.float32)
    return [torch.from_numpy(a).to(device or "cpu") for a in (x, y)]


def _rows(t, W, R):
    return lambda r0: t[r0 * W : (r0 + R) * W]


def _old_blocks_mse(params, x_rows, y_rows, mspec, H, W, C, R, hw=None):
    """The eval's block path before K6: forward, squared error and the live
    region's sum, block by block, into a running SSE."""
    sse = 0.0
    for b in range(-(-H // R)):
        if hw is not None and b * R >= hw[0]:
            break
        r0 = min(b * R, H - R)
        pred = forward(params, x_rows(r0), mspec, fast_act=True)
        skip = b * R - r0
        err = (pred - y_rows(r0)) ** 2
        if hw is None:
            sse = sse + err[skip * W :].sum()
        else:
            sse = sse + err.view(R, W, C)[skip : hw[0] - r0, : hw[1]].sum()
    if hw is None:
        return sse / (H * W * C)
    return sse / float(np.float32(hw[0]) * np.float32(hw[1]) * np.float32(C))


# (case, H, W, R, hw): the last block clamped (H % R != 0), a bucket's real
# shape inside the grid, the harness's eval over the top half (`eval_part`)
CASES = [
    ("clamped", 29, 33, 8, None),
    ("bucket_hw", 24, 40, 5, (21, 35)),
    ("eval_part", 29, 33, 8, (14, 33)),
]


@pytest.mark.parametrize("C,dim_in", SHAPES)
@pytest.mark.parametrize("case,H,W,R,hw", CASES)
def test_blocks_mse_fast_act_matches_block_path(case, H, W, R, hw, C, dim_in):
    """On CPU tensors the fused eval is the plain version, in the old block
    path's order: the same MSE bit for bit."""
    params, mspec = _params(C, dim_in), ModelSpec()
    x, y = _scene(H, W, C, dim_in)
    want = _old_blocks_mse(params, _rows(x, W, R), _rows(y, W, R), mspec, H, W, C, R, hw)
    got = loop.blocks_mse(params, _rows(x, W, R), _rows(y, W, R), mspec, H, W, C, R,
                          fast_act=True, hw=hw, dim_in=dim_in)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert torch.equal(got, want)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("C,dim_in", SHAPES)
def test_expert_eval_through_views(C, dim_in):
    """An expert's eval through `unstack_params` views of a stack is the
    eval of that network alone, and the old block path's."""
    H, W, R = 29, 33, 8
    mspec = ModelSpec()
    nets = [_params(C, dim_in, seed=s) for s in (0, 5)]
    stack = stack_params(nets)
    x, y = _scene(H, W, C, dim_in)
    hws = [(H, W), (20, 30)]
    for e, net in enumerate(nets):
        hw = None if hws[e] == (H, W) else hws[e]
        got = loop.blocks_mse(unstack_params(stack, e), _rows(x, W, R), _rows(y, W, R), mspec,
                              H, W, C, R, fast_act=True, hw=hw, dim_in=dim_in)
        alone = loop.blocks_mse(net, _rows(x, W, R), _rows(y, W, R), mspec, H, W, C, R,
                                fast_act=True, hw=hw, dim_in=dim_in)
        want = _old_blocks_mse(net, _rows(x, W, R), _rows(y, W, R), mspec, H, W, C, R, hw)
        assert torch.equal(got, alone) and torch.equal(got, want)


@pytest.mark.parametrize("skip,rows,cols", [(0, None, None), (3, None, None), (0, 5, 20),
                                            (2, 6, 1), (7, 8, 33)])
def test_plain_live_region_matches_numpy(skip, rows, cols):
    """The plain version sums exactly the live region: image rows skip ..
    rows - 1, columns below cols (numpy, in float64)."""
    C, dim_in, W, R = 4, 100, 33, 8
    params, mspec = _params(C, dim_in), ModelSpec()
    x, y = _scene(R, W, C, dim_in, seed=4)
    pred = forward(params, x, mspec, fast_act=True).numpy().astype(np.float64)
    err = (pred - y.numpy()) ** 2
    i = np.arange(R * W)
    live = (i >= skip * W) & (i < (R if rows is None else rows) * W) & \
        (i % W < (W if cols is None else cols))
    want = err[live].sum()
    out = torch.full((), 0.25)
    got = fs.fused_eval_sse(params, x, y, mspec, W, skip, rows, cols, out=out, dim_in=dim_in)
    assert got is out
    np.testing.assert_allclose(float(got) - 0.25, want, rtol=1e-6)
    np.testing.assert_allclose(float(fs.fused_eval_sse_plain(params, x, y, mspec, W, skip, rows,
                                                             cols)), want, rtol=1e-6)


def test_eval_region_refuses_a_partial_block():
    params, mspec = _params(4, 100), ModelSpec()
    x, y = _scene(3, 10, 4, 100)
    with pytest.raises(ValueError, match="image rows of width"):
        fs.fused_eval_sse(params, x[:-1], y[:-1], mspec, 10)
    with pytest.raises(ValueError, match="outside"):
        fs.fused_eval_sse(params, x, y, mspec, 10, 0, 4)


def test_no_launch_on_the_cpu():
    """A CPU fit and a CPU expert fit evaluate through the plain version:
    the launch counter stays where it was (0 in a CPU process)."""
    n0 = fs.fused_eval_sse.launches
    H, W, C, K = 16, 20, 4, 5
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=3).astype(np.int32)
    msb, lsb = engine.split_msb_lsb(torch.from_numpy(img), K)
    plane, scale = engine.pad_plane(msb, 2)
    t = TrainSpec(epochs=2, batch_size=64)
    fit = loop.fit(plane, scale, lsb, float(engine.lsb_scale(K)), torch.Generator().manual_seed(0),
                   FeatureSpec(), ModelSpec(), t, H, W, C, use_fused=True, device="cpu")
    exp = loop.fit_rate_experts(torch.from_numpy(img), [4, 5], torch.Generator().manual_seed(0),
                                FeatureSpec(), ModelSpec(), t, H, W, C, use_fused=True,
                                device="cpu")
    assert fit.best_epoch in (1, 2) and all(e in (1, 2) for e in exp.best_epoch)
    assert fs.fused_eval_sse.launches == n0 == 0


@pytest.mark.parametrize("dims,rows,staged", [
    ([100, 64, 64, 4], 128, True),     # pms4's eval
    ([200, 64, 64, 8], 64, True),      # wfi8's
    ([128, 64, 64, 4], 64, True),      # dim_in unknown: the padded width
    ([100, 128, 128, 4], 32, True),    # bc 128, nl 2
    ([100, 256, 256, 4], 64, False),   # bc 256: weights from global memory
    ([100, 128, 4], 128, True),        # nl 1: one hidden buffer
])
def test_eval_layout(dims, rows, staged):
    """K6's tile height and weight staging at an H100's shared memory, and
    the carve-up's size at that choice."""
    assert fs.cta_layout(dims, H100_SMEM_OPTIN, fs.eval_smem_bytes, fs.EVAL_ROWS) == (
        rows, staged)
    assert fs.eval_smem_bytes(dims, rows, staged) <= H100_SMEM_OPTIN
    if rows < fs.EVAL_ROWS:
        assert fs.eval_smem_bytes(dims, 2 * rows, staged) > H100_SMEM_OPTIN


def test_eval_smem_bytes_counts_the_carve_up():
    # bars 8, sums + red 512, weights 6400 + 64 + 4096 + 64 + 256 + 4, two
    # hidden buffers 2 x 128 x 68, two stages of 128 x 100 + 512
    assert fs.eval_smem_bytes([100, 64, 64, 4], 128) == 4 * (
        8 + 512 + 10884 + 2 * 128 * 68 + 2 * (128 * 100 + 512))
    assert fs.eval_smem_bytes([100, 64, 64, 4], 128, False) == 4 * (
        8 + 512 + 2 * 128 * 68 + 2 * (128 * 100 + 512))


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K6 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _no_plain(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached fused_eval_sse_plain")

    monkeypatch.setattr(fs, "fused_eval_sse_plain", refuse)


# (case, C, dim_in, spec, W, R, live region): the two cells' blocks, a
# masked one, and a GF-2-like ragged block (16 rows of 7,815: n not a
# multiple of the tile) at bc 256, whose weights stay in global memory
CARD_CASES = [
    ("pms4", 4, 100, ModelSpec(), 2048, 64, (0, None, None)),
    ("wfi8", 8, 200, ModelSpec(), 2048, 64, (0, None, None)),
    ("pms4_masked", 4, 100, ModelSpec(), 2048, 64, (5, 40, 1900)),
    ("gf2_bc256", 4, 100, ModelSpec(256, 2), 7815, 16, (3, None, None)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case,C,dim_in,spec,W,R,region", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda, monkeypatch, case, C, dim_in, spec, W, R, region):
    """K6 against its plain version on the card: the SSE within 1e-5
    relative (summation order and the products' order differ), the same
    bits from two calls, one launch each, and the plain version never
    reached by a CUDA tensor."""
    params = _params(C, dim_in, seed=2, spec=spec, device=cuda)
    x, y = _scene(R, W, C, dim_in, seed=6, device=cuda)
    want = fs.fused_eval_sse_plain(params, x, y, spec, W, *region)
    _no_plain(monkeypatch)
    n0 = fs.fused_eval_sse.launches
    a = fs.fused_eval_sse(params, x, y, spec, W, *region, dim_in=dim_in)
    b = fs.fused_eval_sse(params, x, y, spec, W, *region, dim_in=dim_in)
    torch.cuda.synchronize()
    assert fs.fused_eval_sse.launches == n0 + 2
    assert torch.equal(a, b)
    np.testing.assert_allclose(float(a), float(want), rtol=1e-5)
    # without dim_in the padded columns are multiplied: the same SSE
    c = fs.fused_eval_sse(params, x, y, spec, W, *region)
    np.testing.assert_allclose(float(c), float(want), rtol=1e-5)


def _fit_inputs(H, W, C, K=5):
    img = synth_scene(H, W, channels=C, effective_bits=12, seed=3).astype(np.int32)
    msb, lsb = engine.split_msb_lsb(torch.from_numpy(img), K)
    plane, scale = engine.pad_plane(msb, 2)
    return img, plane, scale, lsb, float(engine.lsb_scale(K))


@pytest.mark.cuda
@pytest.mark.parametrize("staging", ["cached", "full"])
def test_fit_evals_launch_k6_per_block(cuda, monkeypatch, staging):
    """Every eval of a card fit is one K6 launch a row block (two blocks, the
    last clamped), and its MSE agrees with the same eval on the CPU."""
    H, W, C, epochs = 300, 512, 4, 3
    img, plane, scale, lsb, ls = _fit_inputs(H, W, C)
    blocks = -(-H // engine.feature_block_rows(H, W))
    assert blocks == 2
    _no_plain(monkeypatch)
    n0 = fs.fused_eval_sse.launches
    t = TrainSpec(epochs=epochs, batch_size=8192, sample_granule=8)
    got = loop.fit(plane, scale, lsb, ls, torch.Generator().manual_seed(0), FeatureSpec(),
                   ModelSpec(), t, H, W, C, staging=staging, device=cuda)
    assert fs.fused_eval_sse.launches - n0 == blocks * epochs
    monkeypatch.undo()
    x = engine.build_feature_cache(plane, scale, FeatureSpec(), H, W, 128)
    y = engine.build_label_matrix(lsb).to(torch.float32) * ls
    cpu = loop.dataset_mse(got.params.to("cpu"), x, y, ModelSpec(), H, W,
                           engine.feature_block_rows(H, W), fast_act=True)
    np.testing.assert_allclose(got.best_mse, float(cpu), rtol=1e-5)


@pytest.mark.cuda
def test_expert_fit_evals_launch_k6_per_block(cuda, monkeypatch):
    """`fit_rate_experts` at E = 2: one K6 launch a row block, expert and
    eval."""
    H, W, C, epochs, E = 300, 512, 4, 2, 2
    img = _fit_inputs(H, W, C)[0]
    blocks = -(-H // engine.feature_block_rows(H, W))
    _no_plain(monkeypatch)
    n0 = fs.fused_eval_sse.launches
    t = TrainSpec(epochs=epochs, batch_size=8192, sample_granule=8)
    got = loop.fit_rate_experts(torch.from_numpy(img), [4, 5], torch.Generator().manual_seed(0),
                                FeatureSpec(), ModelSpec(), t, H, W, C, device=cuda)
    assert fs.fused_eval_sse.launches - n0 == blocks * epochs * E
    assert len(got.best_mse) == E
