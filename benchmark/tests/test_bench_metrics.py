"""The frozen yardsticks against hand counts."""

import numpy as np
import pytest

import harness
from reference.frozen import busy_union, forward_ops, param_count, psnr, step_cost


@pytest.mark.parametrize("C,P,ops,nbytes", [
    # pms4: dims [100, 64, 64, 4]; wfi8: [200, 64, 64, 8]
    (4, 10884, 2 * 8192 * (2 * 10752 + 4352) + 26 * 8192 * 128 + 12 * 10884,
     4 * (8192 * 100 + 8192 * 4 + 8192) + 24 * 10884 + 4),
    (8, 17544, 2 * 8192 * (2 * 17408 + 4608) + 26 * 8192 * 128 + 12 * 17544,
     4 * (8192 * 200 + 8192 * 8 + 8192) + 24 * 17544 + 4),
])
def test_step_cost_at_the_real_widths(C, P, ops, nbytes):
    dims = [C * 25, 64, 64, C]
    assert param_count(dims) == P
    assert step_cost(8192, dims, P) == (ops, nbytes)
    from lbdrn_msic_tpu_torch.core.config import ModelSpec
    assert ModelSpec().param_count(C * 25, C) == P
    assert forward_ops(10, dims) == 2 * 10 * (C * 25 * 64 + 64 * 64 + 64 * C) + 13 * 10 * 128


def test_busy_union_counts_overlap_once():
    assert busy_union([(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 10)]) == 4
    assert busy_union([]) == 0


def test_psnr_peak_10000():
    a = np.zeros((1, 2, 2), np.uint16)
    b = a + 10
    assert psnr(a, b) == pytest.approx(10 * np.log10(1e8 / 100))


class _Trace:
    def __init__(self, kernels, window_s, busy_s, points):
        self.kernels, self.window_s, self.busy_s, self.points = kernels, window_s, busy_s, points


def _run(trace, jobs_points=(6,), entry="rate_points"):
    from traffic import Job
    cfg = {"bands": 4, "D": 2, "base_channel": 64, "num_layers": 2, "batch_size": 8192,
           "scene_rows": 2048, "scene_cols": 2048, "epochs": 10}
    jobs = [Job(i, 0, 1, [None] * n, {"dispatch": 1.0, "train_wait": 2.0, "finalize": 0.6})
            for i, n in enumerate(jobs_points)]
    return harness.Run("x", {}, cfg, {"entry": entry}, "NVIDIA H100 80GB HBM3", jobs, 10.0,
                       5.0, 2 * 10**9, trace, {})


def test_readers_on_a_hand_made_run():
    k = [("step_partials<true, false, 1>", 0.0, 0.2), ("step_adam", 0.15, 0.25),
         ("step_partials<true, false, 1>", 1.0, 1.2), ("step_adam", 1.15, 1.25),
         ("aten::index_select", 2.0, 2.5)]
    run = _run(_Trace(k, 4.0, 1.0, 6))
    assert harness.reader("fit_s_per_point").read(run) == pytest.approx(3.0 / 6)
    assert harness.reader("host_codec_s").read(run) == pytest.approx(0.1)
    assert harness.reader("loop_kernels_ms").read(run) == pytest.approx(500 / 6)
    assert harness.reader("device_idle.encode").read(run) == pytest.approx(75.0)
    assert harness.reader("peak_mem_gb.encode").read(run) == pytest.approx(2.0)
    ops, nb = step_cost(8192, [100, 64, 64, 4], 10884)
    want = 100 * 2 * 6 * max(ops / 67e12, nb / 3.35e12) / 0.5
    assert harness.reader("step_roofline").read(run) == pytest.approx(want)
    assert harness.reader("encode_mpx_s").read(run) == pytest.approx(6 * 4.194304 / 10)
    assert harness.reader("decode_mpx_s").read(run) is None
    # nothing to read: no value, never 0
    empty = _run(None)
    for name in ("step_roofline", "loop_kernels_ms", "device_idle.encode"):
        assert harness.reader(name).read(empty) is None
