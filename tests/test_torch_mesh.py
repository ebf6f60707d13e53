"""The port's mesh paths on a world of 4 gloo ranks on the CPU
(tests/torch_mesh_worker.py), spawned once for the file; each test reads
its results.  Counterparts of tests/test_parallel.py and test_halo.py held
against the port's own single-process paths: the single-process result is
computed on rank 0 in the same process, because the CPU's matmuls round
differently under another thread count.  Tolerances: dp fits as the JAX
test holds its dp fit (epoch losses rtol 2e-4, params atol 2e-3: the same
batches and draws, the gradient summed in another order); expert fits,
rate-sweep and dataset streams and sp decodes bit for bit; a dp encode
MSB-exact and within 0.1 dB of the single-card encode (bench.py:208-211)."""

import os
import sys

import numpy as np
import pytest

from lbdrn_msic_tpu_torch.codec import decode_stream
from lbdrn_msic_tpu_torch.core.config import CodecConfig, FeatureSpec, ModelSpec, TrainSpec
from lbdrn_msic_tpu_torch.eval.metrics import psnr
from lbdrn_msic_tpu_torch.models.siren import init_params
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mesh_worker import spawn_world  # noqa: E402

WORLD = 4
TS = TrainSpec(epochs=2, batch_size=1024)
IMG = synth_scene(48, 40, channels=2, seed=0)
SWEEP_IMG = synth_scene(48, 48, channels=2, seed=41)
SWEEP_CFGS = [CodecConfig(K=K, base_codec="lpc", train=TS) for K in (3, 5, 7)]
DS_IMGS = [synth_scene(48, 48, channels=2, seed=s) for s in (45, 46)]
BK_IMGS = [synth_scene(100, 90, channels=2, effective_bits=12, seed=47),
           synth_scene(120, 128, channels=2, effective_bits=12, seed=48)]
DP_IMG = synth_scene(64, 64, channels=2, seed=31)
DP_CFG = CodecConfig(K=5, base_codec="lpc", train=TS)
DEC_IMG = synth_scene(64, 48, channels=3, seed=37)
SP_FSPECS = {"rel-D2": FeatureSpec(), "coords": FeatureSpec(use_coords=True),
             "abs-D1": FeatureSpec(D=1, relative=False)}
SP_MSPEC = ModelSpec(base_channel=32, num_layers=2)


def _dec_streams():
    from lbdrn_msic_tpu_torch.codec import encode_image

    one = TrainSpec(epochs=1, batch_size=1024)
    return [encode_image(DEC_IMG, CodecConfig(K=4, base_codec=b, features=f, train=one),
                         device="cpu")[0]
            for b, f in (("lpc", FeatureSpec()), ("lpc", FeatureSpec(use_coords=True)))]


def _sp_params(fspec, C):
    import torch

    p = init_params(torch.Generator().manual_seed(0), fspec.feature_dim(C), C, SP_MSPEC)
    return [t.numpy() for t in p.weights], [t.numpy() for t in p.biases]


def _tasks():
    jobs_ds = [(im, CodecConfig(K=K, base_codec="lpc", train=TS)) for im in DS_IMGS
               for K in (3, 5)]
    jobs_bk = [(im, CodecConfig(K=K, base_codec="lpc", train=TS)) for im in BK_IMGS
               for K in (3, 5)]
    base = DEC_IMG >> 5
    tasks = [
        ("collect", "collect", {}),
        ("mesh_ep2dp2", "make_mesh", {"dp": 2, "ep": 2}),
        ("mesh_bad", "make_mesh", {"dp": 3, "ep": 1}),
        ("fit_dp", "fit_dp", {"img": IMG, "K": 5, "tspec": TS, "seed": 3, "ref": True}),
        ("fit_experts", "fit_experts", {"mesh": "ep2dp2", "img": IMG, "Ks": [3, 5, 7],
                                        "tspec": TS, "seed": 3, "ref": True}),
        ("sweep_ep2dp2", "rate_points", {"mesh": "ep2dp2", "img": SWEEP_IMG,
                                         "cfgs": SWEEP_CFGS, "ref": True}),
        ("sweep_ep4", "rate_points", {"mesh": "ep", "img": SWEEP_IMG, "cfgs": SWEEP_CFGS}),
        ("dataset_cross", "dataset", {"mesh": "ep", "jobs": jobs_ds, "ref": True}),
        ("dataset_bucket", "dataset", {"mesh": "ep", "jobs": jobs_bk, "bucket": True,
                                       "ref": True}),
        ("encode_dp", "encode_image", {"img": DP_IMG, "cfg": DP_CFG, "bucket": True,
                                       "ref": True}),
        ("decode_sp", "decode", {"streams": _dec_streams(), "ref": True}),
        ("decode_sp_pipelined", "decode", {"streams": _dec_streams(), "pipelined": True}),
        ("sp_indivisible", "reconstruct_sp", {"base": synth_scene(30, 16, channels=1, seed=62),
                                              "weights": _sp_params(FeatureSpec(), 1)[0],
                                              "biases": _sp_params(FeatureSpec(), 1)[1],
                                              "fspec": FeatureSpec(), "mspec": SP_MSPEC,
                                              "K": 3}),
    ]
    for name, fspec in SP_FSPECS.items():
        w, b = _sp_params(fspec, 3)
        tasks.append((f"sp_{name}", "reconstruct_sp", {"base": base, "weights": w, "biases": b,
                                                       "fspec": fspec, "mspec": SP_MSPEC, "K": 5,
                                                       "ref": True}))
    return tasks


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(tmp_path_factory.mktemp("mesh4"), WORLD, _tasks())


def _same_on_every_rank(world, name):
    first = world[0][name]["mesh"]
    for r in world[1:]:
        got = r[name]["mesh"]
        if isinstance(first, dict):
            assert all(np.array_equal(a, b) for a, b in zip(got["params"], first["params"]))
            assert np.array_equal(got["step_losses"], first["step_losses"])
            assert got["best_mse"] == first["best_mse"]
        elif isinstance(first, np.ndarray):
            assert np.array_equal(got, first)
        elif isinstance(first, list) and isinstance(first[0], np.ndarray):
            assert all(np.array_equal(a, b) for a, b in zip(got, first))
        else:
            assert got == first


def test_collect_sums_and_gathers(world):
    for r in world:
        np.testing.assert_array_equal(r["collect"]["sum"], [60, 64, 68])
        np.testing.assert_array_equal(r["collect"]["gather"],
                                      [[0, 1, 2], [10, 11, 12], [20, 21, 22], [30, 31, 32]])


def test_make_mesh_axes_and_world_size(world):
    """rank = ep_index * dp + dp_index, as the JAX package reshapes its
    devices to (ep, dp); dp * ep must be the world size."""
    for rank, r in enumerate(world):
        assert r["mesh_ep2dp2"] == {"ep": 2, "dp": 2, "ep_rank": rank // 2, "dp_rank": rank % 2}
        kind, exc, msg = r["mesh_bad"]
        assert exc == "ValueError" and "3 ranks" in msg and "world has 4" in msg


def test_fit_dp_params_bit_identical_across_ranks(world):
    _same_on_every_rank(world, "fit_dp")


def test_fit_dp_matches_single_card_fit(world):
    """fit_dp on 4 ranks against the port's single-card exact `fit` from
    the same draws: the true mean gradient, summed in another order."""
    got, ref = world[0]["fit_dp"]["mesh"], world[0]["fit_dp"]["ref"]
    np.testing.assert_allclose(got["epoch_losses"], ref["epoch_losses"], rtol=2e-4)
    for a, b in zip(got["params"], ref["params"]):
        np.testing.assert_allclose(a, b, atol=2e-3)
    assert got["best_epoch"] == ref["best_epoch"]
    assert got["best_mse"] < 0.2


def test_fit_experts_bit_identical_to_fit_rate_experts(world):
    """E = 3 experts over ep = 2 (rank 1 trains one, its spare slot
    nothing): every rank holds fit_rate_experts' E = 3 result bit for bit."""
    _same_on_every_rank(world, "fit_experts")
    got, ref = world[0]["fit_experts"]["mesh"], world[0]["fit_experts"]["ref"]
    assert all(np.array_equal(a, b) for a, b in zip(got["params"], ref["params"]))
    np.testing.assert_array_equal(got["step_losses"], ref["step_losses"])
    assert got["best_mse"] == ref["best_mse"] and got["best_epoch"] == ref["best_epoch"]
    assert got["staging"] == "full"


@pytest.mark.parametrize("name", ["sweep_ep2dp2", "sweep_ep4"])
def test_encode_rate_points_mesh_ep(world, name):
    """3 rate points on ep = 2 (two rounds, one spare slot) and on ep = 4
    (3 of 4 ranks train): each stream the single-process sweep's byte for
    byte, the same on every rank, decoding MSB-exact."""
    _same_on_every_rank(world, name)
    assert world[0][name]["mesh"] == world[0]["sweep_ep2dp2"]["ref"]
    for cfg, stream in zip(SWEEP_CFGS, world[0][name]["mesh"]):
        rec, dh = decode_stream(stream, device="cpu")
        assert dh.header.K == cfg.K
        np.testing.assert_array_equal(rec >> cfg.K, SWEEP_IMG >> cfg.K)


@pytest.mark.parametrize("name,imgs", [("dataset_cross", DS_IMGS), ("dataset_bucket", BK_IMGS)])
def test_encode_dataset_mesh_ep(world, name, imgs):
    """Cross-image experts of one shape, and bucketed experts of two
    shapes in one bucket (per-expert pad masks), over ep = 4: the
    single-process `encode_dataset`'s streams, decoding at their real
    shapes MSB-exact."""
    _same_on_every_rank(world, name)
    got = world[0][name]["mesh"]
    assert got == world[0][name]["ref"]
    for (im, K), stream in zip([(im, K) for im in imgs for K in (3, 5)], got):
        rec, dh = decode_stream(stream, device="cpu")
        assert rec.shape == im.shape and (dh.header.height, dh.header.width) == im.shape[1:]
        np.testing.assert_array_equal(rec >> K, im >> K)


def test_encode_image_mesh_dp_roundtrip(world):
    """encode_image(mesh=dp4) trains data-parallel: the same stream on
    every rank, MSB-exact, within 0.1 dB of the single-card encode; bucket
    is refused under a mesh with a RuntimeWarning."""
    _same_on_every_rank(world, "encode_dp")
    r = world[0]["encode_dp"]
    rec, _ = decode_stream(r["mesh"], device="cpu")
    np.testing.assert_array_equal(rec >> 5, DP_IMG >> 5)
    solo, _ = decode_stream(r["ref"], device="cpu")
    assert abs(psnr(DP_IMG, rec) - psnr(DP_IMG, solo)) < 0.1
    assert any("bucket" in w for w in r["warnings"])


@pytest.mark.parametrize("name", ["decode_sp", "decode_sp_pipelined"])
def test_decode_mesh_sp_bitexact(world, name):
    """decode_stream / decode_pipelined over sp = 4 (colour and coordinate
    streams): bit-identical to the single-card decode."""
    _same_on_every_rank(world, name)
    ref = world[0]["decode_sp"]["ref"]
    for got, want in zip(world[0][name]["mesh"], ref):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fspec", list(SP_FSPECS))
def test_reconstruct_sp_bitexact(world, fspec):
    """tests/test_halo.py: reconstruct_sp over 4 bands of 16 rows against
    the single-card reconstruction, bit for bit."""
    _same_on_every_rank(world, f"sp_{fspec}")
    r = world[0][f"sp_{fspec}"]
    np.testing.assert_array_equal(r["mesh"], r["ref"])


def test_reconstruct_sp_rejects_indivisible(world):
    for r in world:
        kind, exc, msg = r["sp_indivisible"]
        assert exc == "ValueError" and "divide" in msg
