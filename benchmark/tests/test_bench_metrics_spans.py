"""The readers of the program's spans inside the fit and the decode's wait
(`step_issue_us`, `device_idle.steps`, `device_idle.eval`,
`eval_roofline`, `decode_wait_ms`) on hand-made runs: their values, and
nothing outside their entry or where the program records no such span."""

import pytest

import harness
from reference.frozen import forward_ops
from traffic import Job

CFG = {"bands": 4, "D": 2, "base_channel": 64, "num_layers": 2, "batch_size": 8192,
       "scene_rows": 2048, "scene_cols": 2048, "epochs": 10}
PHASES = {"dispatch": 3.0, "stage": 0.2, "steps": 1.5, "eval": 1.0, "eval_device": 0.4,
          "train_wait": 0.1, "finalize": 0.05}
ENCODE_READERS = ("step_issue_us", "device_idle.steps", "device_idle.eval", "eval_roofline")


def _trace(gaps, window_s=10.0):
    return harness.Trace([("k", 0.0, 1.0)], window_s, 1.0, gaps, 6)


def _run(phases=PHASES, trace=None, entry="rate_points", points=(6, 6), steps=5120,
         epochs=10):
    jobs = [Job(i, 0, 1, [None] * n, None if phases is None else dict(phases),
                steps=(steps, steps)) for i, n in enumerate(points)]
    return harness.Run("x", {}, dict(CFG, epochs=epochs), {"entry": entry},
                       "NVIDIA H100 80GB HBM3", jobs, 10.0, 5.0, None, trace, {})


def test_step_issue_us():
    assert harness.reader("step_issue_us").read(_run()) == pytest.approx(2 * 1.5 / (2 * 5120) * 1e6)


def test_device_idle_by_phase():
    run = _run(trace=_trace([("dispatch", 2.0), ("steps", 1.5), ("eval", 0.25)]))
    assert harness.reader("device_idle.steps").read(run) == pytest.approx(15.0)
    assert harness.reader("device_idle.eval").read(run) == pytest.approx(2.5)
    # the phase recorded, no idle gap inside it: 0
    quiet = _run(trace=_trace([("dispatch", 2.0)]))
    assert harness.reader("device_idle.steps").read(quiet) == 0.0
    assert harness.reader("device_idle.eval").read(quiet) == 0.0


def test_eval_roofline():
    want = 100 * 12 * 10 * forward_ops(2048 * 2048, [100, 64, 64, 4]) / (2 * 0.4 * 67e12)
    assert harness.reader("eval_roofline").read(_run()) == pytest.approx(want)
    assert harness.reader("eval_roofline").read(_run(epochs=1)) == 0.0


def test_decode_wait_ms():
    phases = {"base_decode": 0.1, "dispatch": 0.05, "dispatch_wait": 0.2, "fetch_assemble": 0.15}
    run = _run(phases, entry="decode", points=(1, 1, 1, 1))
    assert harness.reader("decode_wait_ms").read(run) == pytest.approx(200.0)


@pytest.mark.parametrize("name", ENCODE_READERS + ("decode_wait_ms",))
def test_nothing_to_read_gives_none(name):
    """Outside their entry, without a trace where they read one, or on a
    program that records no such span (the parent's): None, never 0."""
    r = harness.reader(name)
    gaps = _trace([("dispatch", 2.0)])
    other = "decode" if name in ENCODE_READERS else "rate_points"
    assert r.read(_run(trace=gaps, entry=other)) is None
    old = {"dispatch": 3.0, "train_wait": 0.1, "base_decode": 0.1, "fetch_assemble": 0.1}
    entry = "rate_points" if name in ENCODE_READERS else "decode"
    assert r.read(_run(old, trace=gaps, entry=entry)) is None
    assert r.read(_run(None, trace=gaps, entry=entry)) is None
    if name.startswith("device_idle"):
        assert r.read(_run(trace=None)) is None
