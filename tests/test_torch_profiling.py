"""The port's spans: `PhaseTimer` (a monotonic clock, nested phases, a
profiler range while a profiler runs, sums safe across threads), the fit's
phases (`stage`, `steps`, `eval`, `eval_device`, `stage_device`) and their
trip through the codec paths, the base coders' `base_code`, the dataset
chunk path's phases, the pipelined decode's `dispatch_wait`, and the
operator's trace of every thread."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from lbdrn_msic_tpu_torch import codec
from lbdrn_msic_tpu_torch.core.config import CodecConfig, FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.features import engine
from lbdrn_msic_tpu_torch.train import loop
from lbdrn_msic_tpu_torch.utils import profiling
from lbdrn_msic_tpu_torch.utils.profiling import PhaseTimer
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

C = 4
FIT_PHASES = {"stage", "steps", "eval"}


class CountingTimer(PhaseTimer):
    """A PhaseTimer that also counts how often each phase opens."""

    def __init__(self):
        super().__init__()
        self.opened = {}

    def phase(self, name):
        self.opened[name] = self.opened.get(name, 0) + 1
        return super().phase(name)


def _cfg(K, epochs=2, **kw):
    t = TrainSpec(epochs=epochs, batch_size=512, sample_granule=8)
    return CodecConfig(K=K, base_codec="lpc", train=t, **kw)


@pytest.fixture(scope="module")
def scene():
    return synth_scene(32, 40, channels=C, effective_bits=12, seed=5)


# ------------------------------------------------------------------ PhaseTimer
def test_phase_ignores_wall_clock_jumps(monkeypatch):
    """Durations come from the monotonic clock: a wall clock that jumps by
    an hour at every read moves nothing."""
    wall = iter(range(0, 10**9, 3600))
    monkeypatch.setattr(time, "time", lambda: float(next(wall)))
    t = PhaseTimer()
    with t.phase("x"):
        time.sleep(0.01)
    assert 0.005 < t.phases["x"] < 1.0


def test_nested_phases_each_record_their_seconds():
    t = PhaseTimer()
    with t.phase("outer"):
        time.sleep(0.01)
        with t.phase("inner"):
            time.sleep(0.02)
        with t.phase("inner"):
            time.sleep(0.02)
    assert t.phases["inner"] >= 0.04
    assert t.phases["outer"] >= t.phases["inner"] + 0.01


def test_phase_is_a_profiler_range_only_under_a_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    t = PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.phase("ranged"):
            torch.ones(4).add_(1)
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert "phase:ranged" in names

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with t.phase("plain"):
        pass
    assert "plain" in t.phases


def test_phase_sums_exactly_from_eight_threads(monkeypatch):
    """8 threads closing 1,000 spans each of one name (as a rate sweep's or
    a dataset's base coders close `base_code` beside each other) add up
    exactly: each span reads 1.0 s on a per-thread clock that hands the
    GIL on at every read, so an addition that is not atomic loses some."""
    local = threading.local()

    def clock():
        local.n = getattr(local, "n", -1) + 1
        time.sleep(0)
        return float(local.n)

    monkeypatch.setattr(profiling.time, "perf_counter", clock)
    t = PhaseTimer()

    def work():
        for _ in range(1000):
            with t.phase("base_code"):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert t.phases == {"base_code": 8000.0}


def test_device_phase_records_nothing_off_cuda():
    t = PhaseTimer()
    with t.device_phase("d", torch.device("cpu")) as stop:
        torch.ones(4).sum()
        stop()
    assert t.phases == {}


def test_trace_keeps_a_worker_threads_range(tmp_path):
    """The operator's trace (`--trace`) holds ranges opened on worker
    threads: the decode's dispatch worker, the base codecs' pools."""
    t = PhaseTimer()

    def work():
        with t.phase("on_worker"):
            torch.ones(8).mul_(2)

    with profiling.trace(str(tmp_path)):
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=60)
        with t.phase("on_caller"):
            torch.ones(8).mul_(2)
    assert not th.is_alive()
    (path,) = tmp_path.iterdir()
    with open(path) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"phase:on_worker", "phase:on_caller"} <= names


# ------------------------------------------------------------------ the fit
def _fit_inputs(scene, K):
    msb, lsb = engine.split_msb_lsb(torch.from_numpy(scene.astype(np.int32)), K)
    plane, scale = engine.pad_plane(msb, 2)
    return plane, scale, lsb, float(np.float32(engine.lsb_scale(K)))


@pytest.mark.parametrize("use_fused", [False, True])
def test_fit_spans_and_bits_unchanged(scene, use_fused):
    """`fit` with a timer records stage once, steps once an epoch, eval
    once an eval, no eval_device on the CPU; its params and losses are
    those of the fit without a timer, bit for bit."""
    plane, scale, lsb, ls = _fit_inputs(scene, 5)
    t = TrainSpec(epochs=3, batch_size=256, sample_granule=8)
    H, W = scene.shape[1:]

    def run(timer):
        return loop.fit(plane, scale, lsb, ls, torch.Generator().manual_seed(7), FeatureSpec(),
                        ModelSpec(), t, H, W, C, use_fused=use_fused, device="cpu",
                        timer=timer)

    timer = CountingTimer()
    got, ref = run(timer), run(None)
    assert timer.opened == {"stage": 1, "steps": 3, "eval": 3}
    assert set(timer.phases) == FIT_PHASES and all(v > 0 for v in timer.phases.values())
    assert torch.equal(got.step_losses, ref.step_losses)
    assert got.best_mse == ref.best_mse and got.best_epoch == ref.best_epoch
    for a, b in zip(got.params.leaves() + got.final_params.leaves(),
                    ref.params.leaves() + ref.final_params.leaves()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("staging", ["full", "banded"])
def test_fit_rate_experts_spans_and_bits_unchanged(scene, staging):
    """`fit_rate_experts` with a timer: stage once, steps once an epoch,
    eval once an expert eval; bit for bit the fit without a timer."""
    t = TrainSpec(epochs=2, batch_size=256, sample_granule=8)
    H, W = scene.shape[1:]
    img = torch.from_numpy(scene.astype(np.int32))

    def run(timer):
        return loop.fit_rate_experts(img, [3, 5, 6], torch.Generator().manual_seed(7),
                                     FeatureSpec(), ModelSpec(), t, H, W, C, staging=staging,
                                     device="cpu", timer=timer)

    timer = CountingTimer()
    got, ref = run(timer), run(None)
    assert timer.opened == {"stage": 1, "steps": 2, "eval": 2 * 3}
    assert set(timer.phases) == FIT_PHASES
    assert torch.equal(got.step_losses, ref.step_losses)
    assert got.best_mse == ref.best_mse and got.best_epoch == ref.best_epoch
    for a, b in zip(got.params.leaves(), ref.params.leaves()):
        assert torch.equal(a, b)


def test_single_epoch_fit_has_no_eval(scene):
    plane, scale, lsb, ls = _fit_inputs(scene, 4)
    H, W = scene.shape[1:]
    timer = PhaseTimer()
    loop.fit(plane, scale, lsb, ls, torch.Generator().manual_seed(1), FeatureSpec(), ModelSpec(),
             TrainSpec(epochs=1, batch_size=256), H, W, C, device="cpu", timer=timer)
    assert set(timer.phases) == {"stage", "steps"}


# ------------------------------------------------------------------ the codec paths
def _nested_in_dispatch(ph):
    assert FIT_PHASES <= set(ph) and "eval_device" not in ph
    assert ph["dispatch"] >= ph["stage"] + ph["steps"] + ph["eval"]


def test_encode_image_nests_the_fit_in_dispatch(scene):
    _, stats = codec.encode_image(scene, _cfg(5), device="cpu")
    assert {"dispatch", "train_wait", "weights_codec", "base_wait"} <= set(stats.phases)
    _nested_in_dispatch(stats.phases)


def test_rate_points_nest_the_fit_in_dispatch(scene):
    res = codec.encode_rate_points(scene, [_cfg(K) for K in (3, 5)], device="cpu")
    ph = res[0][1].phases
    assert {"dispatch", "train_wait", "finalize"} <= set(ph)
    _nested_in_dispatch(ph)
    assert res[1][1].phases == ph


@pytest.mark.parametrize("chunks", [1, 2])
def test_dataset_chunk_points_share_their_chunks_phases(scene, monkeypatch, chunks):
    """`encode_dataset`'s chunk path: every point of a chunk carries the
    chunk's phases (dispatch with the fit inside it, train_wait,
    finalize), equal dicts; two chunks, two dicts."""
    imgs = [scene, synth_scene(32, 40, channels=C, effective_bits=12, seed=6)]
    jobs = [(im, _cfg(K)) for im in imgs for K in (3, 4)]
    if chunks == 2:  # room for one image's two experts and its stores a chunk
        one = 32 * 40 * C * 25 * 2
        monkeypatch.setattr(codec, "STAGE_BUDGET_BYTES", 2 * one + 4 * 32 * 40 * C)
    res = codec.encode_dataset(jobs, device="cpu")
    assert len(res[0][1].plan.chunks) == chunks
    dicts = []
    for chunk in res[0][1].plan.chunks:
        ph = res[chunk[0]][1].phases
        assert {"dispatch", "train_wait", "finalize"} <= set(ph)
        _nested_in_dispatch(ph)
        assert all(res[j][1].phases == ph for j in chunk)
        dicts.append(ph)
    assert len({tuple(sorted(d.items())) for d in dicts}) == chunks


@pytest.mark.parametrize("entry", ["image", "rate_points", "dataset", "pipelined"])
def test_every_encode_entry_times_its_base_coder(scene, entry):
    """Each encode entry that submits the base coder records the coder's
    own seconds on its worker as `base_code`, in the phases its points
    carry (`encode_pipelined`: only that span)."""
    other = synth_scene(32, 40, channels=C, effective_bits=12, seed=6)
    if entry == "image":
        res = [codec.encode_image(scene, _cfg(5), device="cpu")]
    elif entry == "rate_points":
        res = codec.encode_rate_points(scene, [_cfg(K) for K in (3, 5)], device="cpu")
    elif entry == "dataset":  # one chunk of two images x two K
        res = codec.encode_dataset([(im, _cfg(K)) for im in (scene, other) for K in (3, 4)],
                                   device="cpu")
    else:
        res = codec.encode_pipelined([(scene, _cfg(5)), (other, _cfg(5))], device="cpu")
    for _, stats in res:
        assert stats.phases["base_code"] > 0
    if entry == "pipelined":
        assert all(set(stats.phases) == {"base_code"} for _, stats in res)
    else:
        assert "base_wait" in res[0][1].phases or "finalize" in res[0][1].phases


def test_pipelined_decode_records_the_wait_on_its_worker(scene):
    streams = [codec.encode_image(scene, _cfg(K, epochs=1), device="cpu")[0] for K in (4, 5, 6)]
    out = list(codec.decode_pipelined_iter(iter(streams), ahead=1, device="cpu"))
    assert len(out) == 3
    for _, stats in out:
        assert {"dispatch_wait", "fetch_assemble"} <= set(stats.phases)


# ------------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_eval_device_within_eval_on_card(scene):
    """On the card the eval's and the stage's device seconds are recorded,
    above 0 and within their host spans (which end on the eval's own sync,
    and after the init's upload that syncs the stage)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: eval_device reads CUDA events")
    plane, scale, lsb, ls = _fit_inputs(scene, 5)
    H, W = scene.shape[1:]
    timer = PhaseTimer()
    loop.fit(plane, scale, lsb, ls, torch.Generator().manual_seed(7), FeatureSpec(), ModelSpec(),
             TrainSpec(epochs=2, batch_size=256, sample_granule=8), H, W, C, device="cuda",
             timer=timer)
    assert 0 < timer.phases["eval_device"] <= timer.phases["eval"]
    assert 0 < timer.phases["stage_device"] <= timer.phases["stage"]
    img = torch.from_numpy(scene.astype(np.int32))
    timer = PhaseTimer()
    loop.fit_rate_experts(img, [3, 5], torch.Generator().manual_seed(7), FeatureSpec(),
                          ModelSpec(), TrainSpec(epochs=2, batch_size=256, sample_granule=8),
                          H, W, C, device="cuda", timer=timer)
    assert 0 < timer.phases["eval_device"] <= timer.phases["eval"]
    assert 0 < timer.phases["stage_device"] <= timer.phases["stage"]
