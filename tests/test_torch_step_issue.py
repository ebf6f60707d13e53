"""The host's step issue (CPU, small shapes, port only):

- chunked staging: `fit` and `fit_rate_experts` stage an epoch's batches a
  chunk of steps at a time (`loop.chunk_steps`, from MULTI_STEP_BYTES) and
  still make one call of the step function a step, found by its name in
  `train.loop` at each call as the benchmark's step tap finds it.  Every
  call's x / y / mask equals the batch built for that step alone (the same
  fit in chunks of one step), and params, losses, best MSE and best epoch
  are bit for bit the one-step-chunk fit's, over a chunk boundary that
  does not divide the epoch; the `dp_group` path chunks each rank's
  slices, bit for bit as well (a gloo world of 2);
- the launch plan of `ops/fused_step.py::_launch`: one bind over many
  launches of the same leaves, a rebind for any other leaf set, batch,
  `mm_dtype`, spec or stream, today's ValueError for a bad tensor on the
  first call and on a later one, and lr, c1, c2 bit for bit those of
  `bias_corrections` (the kernel library stubbed by a recorder).
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from lbdrn_msic_tpu_torch.core.config import FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.features import engine
from lbdrn_msic_tpu_torch.models.siren import init_params, pad_dim
from lbdrn_msic_tpu_torch.ops import fused_step as fs
from lbdrn_msic_tpu_torch.train import loop
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mesh_worker import spawn_world  # noqa: E402

H, W, C, K = 12, 16, 4, 5
BS, EPOCHS, CHUNK = 24, 2, 3  # 8 steps an epoch at g 1 and 8: chunks of 3, 3, 2
STEP_NAMES = ("fused_train_step", "reference_train_step", "fused_expert_step",
              "_exact_expert_step")
PADDED_IN = pad_dim(FeatureSpec().feature_dim(C))


def _img(seed=5):
    return synth_scene(H, W, channels=C, effective_bits=12, seed=seed)


@contextlib.contextmanager
def _tapped(chunk_bytes):
    """train.loop's step functions wrapped by name, each call's batch
    kept, and MULTI_STEP_BYTES set to `chunk_bytes`; yields the calls."""
    calls = []
    saved = {n: getattr(loop, n) for n in STEP_NAMES + ("MULTI_STEP_BYTES",)}

    def wrap(real):
        def step(params, m, v, x, y, mask, lr, t, *a, **kw):
            calls.append((x.clone(), y.clone(), mask.clone(), lr, t))
            return real(params, m, v, x, y, mask, lr, t, *a, **kw)
        return step

    try:
        for n in STEP_NAMES:
            setattr(loop, n, wrap(saved[n]))
        loop.MULTI_STEP_BYTES = chunk_bytes
        yield calls
    finally:
        for n, v in saved.items():
            setattr(loop, n, v)


def _same_fit(a, b):
    return (torch.equal(a.step_losses, b.step_losses) and a.best_mse == b.best_mse
            and a.best_epoch == b.best_epoch
            and all(torch.equal(x, y) for x, y in zip(a.params.leaves(), b.params.leaves()))
            and all(torch.equal(x, y)
                    for x, y in zip(a.final_params.leaves(), b.final_params.leaves())))


def _same_calls(a, b):
    return len(a) == len(b) and all(
        torch.equal(xa, xb) and torch.equal(ya, yb) and torch.equal(ma, mb)
        and la == lb and ta == tb for (xa, ya, ma, la, ta), (xb, yb, mb, lb, tb) in zip(a, b))


def _chunked_and_one_step(run, E, counter):
    """run() in chunks of CHUNK steps and of one step: (results, calls,
    chunks staged) of each."""
    out = []
    for nbytes in (CHUNK * E * BS * PADDED_IN * 4, 1):
        n0 = counter.chunks
        with _tapped(nbytes) as calls:
            res = run()
        out.append((res, calls, counter.chunks - n0))
    return out


@pytest.mark.parametrize("hw", [None, (10, 13)])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("staging", ["cached", "full", "banded", "gather"])
def test_fit_chunks_one_call_a_step(staging, g, hw):
    msb, lsb = engine.split_msb_lsb(torch.from_numpy(_img().astype(np.int32)), K)
    plane, scale = engine.pad_plane(msb, 2)
    t = TrainSpec(batch_size=BS, epochs=EPOCHS, sample_granule=g)
    geo = loop._batch_geometry(t, H, W, staging)
    assert geo.steps == 8 and loop.chunk_steps(1, BS, PADDED_IN, geo.steps) == geo.steps

    def run():
        return loop.fit(plane, scale, lsb, engine.lsb_scale(K), torch.Generator().manual_seed(2),
                        FeatureSpec(), ModelSpec(), t, H, W, C, staging=staging, use_fused=True,
                        hw=hw, device="cpu")

    (chunked, calls, chunks), (one, one_calls, one_chunks) = _chunked_and_one_step(run, 1, loop.fit)
    assert len(calls) == len(one_calls) == EPOCHS * geo.steps
    assert (chunks, one_chunks) == (EPOCHS * 3, EPOCHS * geo.steps)
    assert [c[4] for c in calls] == list(range(1, EPOCHS * geo.steps + 1))
    assert _same_calls(calls, one_calls)
    assert _same_fit(chunked, one)


@pytest.mark.parametrize("masks", ["shared", "per_expert"])
@pytest.mark.parametrize("staging", ["full", "banded"])
def test_fit_rate_experts_chunks_one_call_a_step(staging, masks):
    Ks = (3, 5)
    t = TrainSpec(batch_size=BS, epochs=EPOCHS, sample_granule=8)
    hws = [(H, W), (10, 13)] if masks == "per_expert" else None

    def run():
        return loop.fit_rate_experts(torch.from_numpy(_img().astype(np.int32)), Ks,
                                     torch.Generator().manual_seed(2), FeatureSpec(),
                                     ModelSpec(), t, H, W, C, use_fused=True, staging=staging,
                                     hws=hws, device="cpu")

    (chunked, calls, chunks), (one, one_calls, one_chunks) = _chunked_and_one_step(
        run, len(Ks), loop.fit_rate_experts)
    steps = loop._batch_geometry(t, H, W, staging).steps
    assert steps == 8
    assert len(calls) == len(one_calls) == EPOCHS * steps
    assert (chunks, one_chunks) == (EPOCHS * 3, EPOCHS * steps)
    assert all(c[2].shape == ((len(Ks), BS) if hws else (BS,)) for c in calls)
    assert _same_calls(calls, one_calls)
    assert _same_fit(chunked, one)


def test_fit_dp_chunks_each_ranks_slices(tmp_path):
    """fit(dp_group=) over 2 gloo ranks stages each rank's slices of a
    chunk's batches (chunk_steps at the rank's bs / dp rows a step): the
    same calls with the same batches, and the same fit bit for bit, as in
    chunks of one step."""
    t = TrainSpec(batch_size=BS, epochs=EPOCHS, sample_granule=4)
    chunk_bytes = CHUNK * (BS // 2) * PADDED_IN * 4
    ranks = spawn_world(tmp_path, 2, [("chunks", "fit_dp_chunks",
                                      {"img": _img(), "K": K, "tspec": t,
                                       "chunk_bytes": chunk_bytes})])
    for r in ranks:
        out = r["chunks"]
        assert not isinstance(out, tuple), out  # a raised task
        a, b = out["chunked"], out["one_step"]
        assert a["calls"] == b["calls"] == EPOCHS * 8
        assert (a["chunks"], b["chunks"]) == (EPOCHS * 3, EPOCHS * 8)
        assert out["batches_equal"]
        assert np.array_equal(a["step_losses"], b["step_losses"])
        assert (a["best_mse"], a["best_epoch"]) == (b["best_mse"], b["best_epoch"])
        assert all(np.array_equal(x, y) for x, y in zip(a["params"], b["params"]))


# ------------------------------------------------------------------ the plan
class _Lib:
    """Stands in for the kernel library: records each launch's arguments."""

    def __init__(self):
        self.launches = []

    def lbdrn_fused_step(self, *args):
        self.launches.append(args)
        return 0


@pytest.fixture
def lib(monkeypatch):
    rec = _Lib()
    monkeypatch.setattr(fs, "_kernel_lib", lambda: rec)
    monkeypatch.setattr(fs, "_smem_optin", 227 * 1024)
    monkeypatch.setattr(fs, "_raw_stream", lambda dev: rec.stream)
    monkeypatch.setattr(fs, "_plans", {})
    rec.stream = 0
    return rec


def _state(B=64, E=None, seed=0):
    mspec = ModelSpec()
    p = init_params(torch.Generator().manual_seed(seed), FeatureSpec().feature_dim(C), C, mspec,
                    pad_input_to=PADDED_IN)
    if E is not None:
        p = p.map(lambda t: t.expand(E, *t.shape).contiguous())
    lead = () if E is None else (E,)
    x = torch.rand(*lead, B, PADDED_IN)
    y = torch.rand(*lead, B, C)
    mask = torch.ones(B)
    return mspec, p, p.map(torch.zeros_like), p.map(torch.zeros_like), x, y, mask


def _launch(st, step=1, lr=1e-3, E=None, mm_dtype=None, x=None, y=None, mask=None, loss=None,
            mspec=None):
    ms, p, m, v, x0, y0, mask0 = st
    return fs._launch(p, m, v, x0 if x is None else x, y0 if y is None else y,
                      mask0 if mask is None else mask, lr, step, ms if mspec is None else mspec,
                      C, loss, E, mm_dtype)


def test_plan_binds_once_a_leaf_set(lib):
    """The same leaves: one bind over many launches, one scratch buffer;
    new views of a batch buffer each step (as the loops pass them) keep the
    plan, and so do the K2 plan's launches beside it."""
    fs.fused_train_step.binds = fs.fused_expert_step.binds = 0
    st = _state()
    buf = torch.rand(4, 64, PADDED_IN)
    for s in range(12):
        _launch(st, step=s + 1, x=buf[s % 4], loss=torch.zeros(()))
    st2 = _state(E=3)
    for s in range(5):
        _launch(st2, step=s + 1, E=3)
        _launch(st, step=13 + s)
    assert (fs.fused_train_step.binds, fs.fused_expert_step.binds) == (1, 1)
    assert len({a[6] for a in lib.launches}) == 2  # K1's scratch and K2's


def test_plan_rebinds(lib):
    """A replaced leaf, a new batch, mm_dtype, spec, mask rank or stream
    rebinds; back to the bound set rebinds again (one plan a kind)."""
    fs.fused_train_step.binds = fs.fused_expert_step.binds = 0
    st = _state()
    _launch(st)
    _launch(st)
    assert fs.fused_train_step.binds == 1
    ms, p, m, v, x, y, mask = st
    p2 = fs.SirenParams(list(p.weights), list(p.biases))
    p2.biases[1] = p.biases[1].clone()  # one leaf replaced
    _launch((ms, p2, m, v, x, y, mask))
    assert fs.fused_train_step.binds == 2
    _launch(st)
    assert fs.fused_train_step.binds == 3
    _launch(st, x=torch.rand(48, PADDED_IN), y=torch.rand(48, C), mask=torch.ones(48))
    assert fs.fused_train_step.binds == 4
    _launch(st, mm_dtype="bfloat16")
    assert fs.fused_train_step.binds == 5
    _launch(st, mspec=ModelSpec(w0=20.0))
    assert fs.fused_train_step.binds == 6
    lib.stream = 7
    _launch(st)
    assert fs.fused_train_step.binds == 7
    st3 = _state(E=2)
    _launch(st3, E=2)
    _launch(st3, E=2, mask=torch.ones(2, 64))  # per-expert masks
    assert fs.fused_expert_step.binds == 2
    assert lib.launches[-1][5] == 64  # the mask's stride between experts


BAD = {
    "x dtype": lambda st: {"x": st[4].double()},
    "y shape": lambda st: {"y": torch.rand(64, C + 1)},
    "mask device": lambda st: {"mask": torch.ones(64, device="meta")},
    "x non-contiguous": lambda st: {"x": torch.rand(PADDED_IN, 64).T},
    "loss shape": lambda st: {"loss": torch.zeros(1)},
    "mm_dtype": lambda st: {"mm_dtype": "float16"},
}


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("bad", sorted(BAD))
def test_plan_keeps_the_checks(lib, bad, first):
    """A bad tensor raises today's ValueError on a first call and on a call
    after the plan is bound, and launches nothing."""
    st = _state()
    if not first:
        _launch(st)
        _launch(st)
    n = len(lib.launches)
    with pytest.raises(ValueError) as got:
        _launch(st, **BAD[bad](st))
    # the message of the checks without a plan: bind from nothing
    fs._plans.clear()
    with pytest.raises(ValueError) as want:
        _launch(st, **BAD[bad](st))
    assert str(got.value) == str(want.value)
    assert len(lib.launches) == n


def test_plan_hands_the_kernel_lr_and_corrections(lib):
    """lr and the bias corrections reach the launch bit for bit as
    float(np.float32(lr)) and `bias_corrections` compute them."""
    st = _state()
    sched = loop.make_lr_schedule(TrainSpec(epochs=10), 40)
    steps = [1, 2, 3, 157, 158, 159, 400, 16000, 16700, 72560]
    for t in steps:
        _launch(st, step=t, lr=sched(t - 1))
    for t, a in zip(steps, lib.launches[-len(steps):]):
        lr, c1, c2 = a[11:14]
        f32 = lambda v: np.float32(v).view(np.uint32)
        assert f32(lr) == f32(np.float32(sched(t - 1)))
        assert (c1, c2) == fs.bias_corrections.__wrapped__(t)


def test_lr_schedule_unchanged():
    """make_lr_schedule's step schedule gives, step for step, the float32
    formula it always used."""
    t = TrainSpec(epochs=10)
    steps_per_epoch = 7
    sched = loop.make_lr_schedule(t, steps_per_epoch)
    f32 = np.float32
    for step in range(0, 10 * steps_per_epoch):
        epoch = step // steps_per_epoch
        want = float(f32(t.lr) * f32(t.lr_gamma) ** f32(epoch // t.lr_step_size()))
        assert sched(step) == want
