"""The plain reference against the port's plain CPU path at a tiny size;
the judge's control and planted faults come out not correct; the run's
refusals (no card, JAX loaded)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import harness
from reference import plain
from reference.frozen import synth_scene
from reference.stream import lfpz_decode, parse_header, tile_weights

TINY = {"scene_rows": 64, "scene_cols": 64, "batch_size": 512, "epochs": 2}
CPU = torch.device("cpu")


def test_features_bit_identical_to_the_port():
    from lbdrn_msic_tpu_torch.core.config import FeatureSpec
    from lbdrn_msic_tpu_torch.features.engine import pad_plane, row_block_features

    scene = synth_scene(40, 48, 4, 12, seed=3)
    for K in (1, 5):
        plane = plain.BasePlane(scene, K, 2, CPU)
        padded, scale = pad_plane(torch.from_numpy(scene.astype(np.int32)) >> K, 2)
        want = row_block_features(padded, scale, 8, FeatureSpec(), 40, 48, 16)
        got = plane.features(8, 16)
        assert torch.equal(got, want)


def test_stream_reader_and_decode_against_the_port():
    from lbdrn_msic_tpu_torch import codec
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.io.header import decode_header

    scene = synth_scene(64, 64, 4, 12, seed=11)
    cfg = CodecConfig(K=5, base_codec="lpc", train=TrainSpec(epochs=2, batch_size=512,
                                                             sample_granule=8))
    stream, _ = codec.encode_image(scene, cfg, seed=3, device="cpu")
    h = parse_header(stream)
    ref = decode_header(stream)
    assert (h["K"], h["width"], h["height"], h["nn_bytes"], h["base_bytes"], h["base_codec"]) \
        == (ref.K, ref.width, ref.height, ref.nn_bytes, ref.base_bytes, ref.base_codec)
    flat = lfpz_decode(tile_weights(stream, h)[0])
    from lbdrn_msic_tpu_torch.codecs.weights import decompress
    nn = stream[h["header_bytes"]: h["header_bytes"] + h["nn_bytes"][0]]
    assert np.array_equal(flat.view(np.uint32), decompress(nn).view(np.uint32))
    dec, _ = codec.decode_stream(stream, device="cpu")
    plane = plain.BasePlane(scene, 5, 2, CPU)
    r = plain.judge_decode(plane, plain.layers_from_flat(flat, [100, 64, 64, 4], CPU), dec)
    assert r["msb_wrong"] == 0 and r["flips"] / r["n"] <= 1e-3 and 0 < r["mse_ratio"] < 1.5
    ref_img = plain.reconstruct(plane, plain.layers_from_flat(flat, [100, 64, 64, 4], CPU))
    assert np.mean(ref_img != dec) <= 1e-3


def test_training_step_against_the_port():
    from lbdrn_msic_tpu_torch.core.config import ModelSpec
    from lbdrn_msic_tpu_torch.models.siren import init_params
    from lbdrn_msic_tpu_torch.ops.fused_step import reference_train_step

    gen = torch.Generator().manual_seed(0)
    p = init_params(gen, 100, 4, ModelSpec(), pad_input_to=128)
    x = torch.zeros(256, 128)
    x[:, :100] = torch.rand(256, 100, generator=gen) * 2 - 1
    y, mask = torch.rand(256, 4, generator=gen), torch.ones(256)
    assert plain.init_violations(p.weights, p.biases, [100, 64, 64, 4]) == 0
    L = len(p.weights)
    ws, bs = [t.clone() for t in p.weights], [t.clone() for t in p.biases]
    zeros = [torch.zeros_like(t) for t in ws + bs]
    new, m, v, loss, grads = plain.train_step(ws, bs, zeros, zeros, x, y, mask, 1e-3, 1)
    q = p.map(torch.clone)
    _, qm, _, qloss = reference_train_step(q, q.map(torch.zeros_like), q.map(torch.zeros_like),
                                           x, y, mask, 1e-3, 1, ModelSpec(), 4)
    assert loss == pytest.approx(float(qloss), rel=1e-6)
    for a, b in zip(new, q.leaves()):
        assert torch.allclose(a, b, atol=2e-3 + 1e-6)  # a sign flip of a ~0 gradient moves 2 lr
    for a, b in zip(m, qm.leaves()):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-9)


def _tiny(workload, mode=None, seconds=0.5):
    return harness.run_cell(workload, 20250101, seconds, False, CPU, overrides=TINY,
                            mode=mode)["result"]


@pytest.mark.parametrize("mode,number", [
    ("control", "step_grad_gap"), ("unchanged", "step_change_gap"),
    ("half_batch", "rows_live_wrong"), ("half_batch_step", "step_loss_gap"),
    ("repeat_rows", "rows_repeated"), ("eval_part", "eval_mse_gap"),
    ("eval_skip", "evals_wrong"), ("answer_altered", "flip_share"),
])
def test_encode_control_and_faults_fail(mode, number):
    """The sweep at a tiny size: the sound run's number is far below what
    the control or the fault reads, and the fault's run is not correct."""
    sound = _tiny("pms4.sweep")["checks"]
    bad = _tiny("pms4.sweep", mode)
    assert bad["correct"] is False
    assert bad["checks"][number]["value"] > 10 * sound[number]["value"]
    assert bad["checks"][number]["value"] > sound[number]["limit"]


@pytest.mark.parametrize("mode", ["control", "half_batch", "answer_altered"])
def test_decode_control_and_faults_fail(mode):
    sound = _tiny("wfi8.decode")
    assert sound["correct"] is True
    bad = _tiny("wfi8.decode", mode)
    assert bad["correct"] is False and bad["checks"]["flip_share"]["value"] > \
        bad["checks"]["flip_share"]["limit"]


def test_forbidden_modules_by_whole_top_level_name():
    code = ("import sys; sys.path.insert(0, %r); import run; "
            "import lbdrn_msic_tpu_torch.codec; print(run.forbidden_modules()); "
            "sys.modules['jax.numpy'] = sys; sys.modules['lbdrn_msic_tpu.codec'] = sys; "
            "print(run.forbidden_modules())") % harness.BENCH_DIR
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.splitlines() == ["[]", "['jax', 'lbdrn_msic_tpu']"]


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pms4.encode",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = harness.run_cell("pms4.encode", 99, 5.0, False, torch.device("cuda"))
    assert out["result"]["correct"] is True


@pytest.mark.parametrize("t,live,off", [
    (1, 8192, 0), (512, 8192, 0), (513, 8192, 0),  # 2048^2 at bs 8192: every batch full
    (3, 4096, 4096), (3, 8200, 8),
])
def test_live_rows_against_the_configured_batch(t, live, off):
    from reference import judge
    geo = judge.batch_geometry({"scene_rows": 2048, "scene_cols": 2048, "batch_size": 8192,
                                "sample_granule": 8})
    assert geo["steps"] == 512
    assert judge.live_rows_off(geo, t, live) == off


def test_live_rows_at_an_epoch_remainder():
    from reference import judge
    # 10 x 10 pixels, granule 4 (25 granules), 8 rows a batch: 4 steps, the last of one granule
    geo = judge.batch_geometry({"scene_rows": 10, "scene_cols": 10, "batch_size": 8,
                                "sample_granule": 4})
    assert (geo["n_g"], geo["bpg"], geo["steps"]) == (25, 2, 13)
    assert judge.live_rows_off(geo, 13, 4) == 0 and judge.live_rows_off(geo, 13, 8) == 4
    assert judge.live_rows_off(geo, 26, 4) == 0  # the next epoch's last step
    geo = judge.batch_geometry({"scene_rows": 10, "scene_cols": 9, "batch_size": 8,
                                "sample_granule": 4})  # 90 pixels: the last granule holds 2
    assert judge.live_rows_off(geo, 1, 6) == 0 and judge.live_rows_off(geo, 1, 5) == 1


def test_rows_against_the_scenes_counts():
    from reference import judge
    keys, counts = torch.tensor([3, 5, 9]), torch.tensor([1, 2, 1])
    assert judge.rows_against(torch.tensor([3, 5, 5, 9]), keys, counts) == (0, 0)
    assert judge.rows_against(torch.tensor([3, 3, 5, 7, 7]), keys, counts) == (2, 1)


class _Stats:
    def __init__(self, mse, epoch):
        self.tiles = [type("T", (), {"best_mse": mse, "best_epoch": epoch})()]


def test_evals_account_for_every_point():
    from reference import judge
    from traffic import Job, Point

    mix = type("M", (), {"c": {"epochs": 3}})()
    # one fit of two experts: epoch by epoch, expert 0 then 1
    evals = [(0, 0, 0.5), (0, 0, 0.9), (0, 1, 0.4), (0, 1, 0.8), (0, 2, 0.45), (0, 2, 0.7)]
    job = Job(0, 0.0, 1.0, [Point(0, 1, b"", _Stats(0.4, 2)), Point(0, 2, b"", _Stats(0.7, 3))],
              None)
    assert judge.judge_evals(mix, [job], evals) == 0
    job.points[0].stats = _Stats(0.45, 3)  # a later, worse checkpoint
    assert judge.judge_evals(mix, [job], evals) == 1
    job.points[0].stats = _Stats(0.4, 2)
    assert judge.judge_evals(mix, [job], evals[:4] + [(0, -1, None), (0, 2, 0.7)]) > 0
    two_fits = [(0, e, v) for e, v in enumerate((0.5, 0.4, 0.45))] * 2
    one = Job(0, 0.0, 1.0, [Point(0, 1, b"", _Stats(0.4, 2))] * 2, None)
    assert judge.judge_evals(mix, [one], two_fits) == 0
    assert judge.judge_evals(mix, [one], two_fits[:3]) == 1  # a point no eval chose
    assert judge.judge_evals(mix, [one], two_fits + two_fits[:3]) == 1  # an eval no point's


def test_codec_config_takes_every_key_and_refuses_unknown_ones():
    from traffic import Mix

    cfg = dict(harness.resolve("pms4.encode")["config"], w0=20.0, val_every=2)
    mix = Mix({"entry": "image", "ks": [5]}, cfg, 1, CPU)
    c = mix.codec_config(5)
    assert (c.model.w0, c.train.val_every, c.train.sample_granule, c.base_codec) == \
        (20.0, 2, 8, "jp2")
    with pytest.raises(ValueError, match="bucket"):
        Mix({"entry": "image", "ks": [5]}, dict(cfg, bucket=True), 1, CPU).codec_config(5)
    with pytest.raises(ValueError, match="split_ratio"):
        Mix({"entry": "image", "ks": [5]}, dict(cfg, split_ratio=2), 1, CPU)


def test_a_mix_refuses_keys_it_does_not_read():
    from traffic import Mix

    cfg = harness.resolve("pms4.encode")["config"]
    with pytest.raises(ValueError, match="bucket"):
        Mix({"entry": "image", "ks": [5], "bucket": True}, cfg, 1, CPU)
