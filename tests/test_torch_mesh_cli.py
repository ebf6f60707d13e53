"""The port's command lines and job scheduler in a world of 2 gloo ranks
on the CPU (tests/torch_mesh_worker.py), spawned once for the file:
`JobScheduler.from_runtime` partitions the jobs by rank
(tests/test_multihost.py:92), `cli.encode` / `cli.decode --mesh dp=2`
round-trip with rank 0 alone writing, and `cli.sweep --batch-experts
--mesh ep=2` fans a sweep's experts out over the ranks.  Without a world,
`initialize_cluster` is a no-op and `from_runtime` is one process
(tests/test_distributed.py:11)."""

import os
import sys

import numpy as np
import pytest

from lbdrn_msic_tpu_torch.codec import decode_stream
from lbdrn_msic_tpu_torch.io.tiff import read_tiff, write_tiff
from lbdrn_msic_tpu_torch.parallel.distributed import JobScheduler, initialize_cluster
from lbdrn_msic_tpu_torch.utils.logging import scrape_log
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mesh_worker import spawn_world  # noqa: E402

FAST = ["-e", "1", "-bs", "1024", "--base-codec", "lpc", "--device", "cpu"]
RUN = "_r1_K{}_bc64_nl2_D2_prec16_lr0.001_bs1024_e1"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh2")
    img = synth_scene(48, 40, channels=2, seed=51)
    tif = str(d / "s.tif")
    write_tiff(tif, img)
    out, sweep_out = str(d / "out"), str(d / "sweep")
    bin_path = os.path.join(out, "s" + RUN.format(5), "s.bin")
    tasks = [
        ("runtime", "from_runtime", {"jobs": [f"j{i}" for i in range(7)]}),
        ("cli", "cli", {"argvs": [
            ("encode", ["-i", tif, "-o", out, "-K", "5", "--mesh", "dp=2"] + FAST),
            ("decode", ["-i", bin_path, "-org", tif, "--keep-recon", "--mesh", "dp=2",
                        "--device", "cpu"]),
            ("encode", ["-i", tif, "-o", out, "-K", "5", "--mesh", "dp=2"] + FAST),
            ("sweep", ["-i", tif, "-o", sweep_out, "--k-min", "3", "--k-max", "4",
                       "--batch-experts", "--mesh", "ep=2"] + FAST),
        ]}),
    ]
    return {"ranks": spawn_world(d, 2, tasks), "img": img, "out": out, "sweep": sweep_out,
            "bin": bin_path}


def test_initialize_cluster_noop_without_env(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_cluster() is None
    s = JobScheduler.from_runtime()
    assert (s.num_processes, s.process_id) == (1, 0)


def test_from_runtime_splits_jobs_over_the_world(world):
    mine = [r["runtime"] for r in world["ranks"]]
    assert [(m["world"], m["rank"]) for m in mine] == [(2, 0), (2, 1)]
    assert mine[0]["mine"] == ["j0", "j2", "j4", "j6"] and mine[1]["mine"] == ["j1", "j3", "j5"]


def test_cli_mesh_dp_round_trip_rank0_writes(world):
    """encode and decode --mesh dp=2: both ranks return 0, rank 0 alone
    prints the logs and writes the run (one encode log, one decode log),
    the stream decodes MSB-exact; a rerun resumes on both ranks."""
    (r0, r1) = (r["cli"] for r in world["ranks"])
    assert [rc for rc, _ in r0] == [rc for rc, _ in r1] == [0, 0, 0, 0]
    assert "Total size" in r0[0][1] and "PSNR" in r0[1][1]
    assert r1[0][1] == r1[1][1] == r1[2][1] == ""
    assert "Bitstream already created!" in r0[2][1]
    run_dir = os.path.dirname(world["bin"])
    assert sorted(os.listdir(run_dir)) == ["decode.txt", "decode.txt.jsonl", "encode.txt",
                                           "encode.txt.jsonl", "s.bin", "s_recon.tif"]
    for log, marker in (("encode.txt", "Time elapsed"), ("decode.txt", "PSNR")):
        with open(os.path.join(run_dir, log)) as f:
            assert f.read().count(marker) == 1
    img = world["img"]
    rec = read_tiff(os.path.join(run_dir, "s_recon.tif"))
    np.testing.assert_array_equal(rec >> 5, img >> 5)
    with open(world["bin"], "rb") as f:
        own, _ = decode_stream(f.read(), device="cpu")
    np.testing.assert_array_equal(own, rec)
    assert scrape_log(os.path.join(run_dir, "decode.txt"))["psnr"] > 50


def test_cli_sweep_batch_experts_over_ep(world):
    """cli.sweep --batch-experts --mesh ep=2 on one scene at K 3..4: each
    rank trains one expert; rank 0 writes both runs and decodes them, the
    other rank prints nothing."""
    (r0, r1) = (r["cli"][3] for r in world["ranks"])
    assert "[sweep] expert-batched encode of 2 jobs over mesh ep=2 x dp=1" in r0[1]
    assert r1[1] == ""
    assert sorted(os.listdir(world["sweep"])) == ["s" + RUN.format(K) for K in (3, 4)]
    for K in (3, 4):
        run_dir = os.path.join(world["sweep"], "s" + RUN.format(K))
        with open(os.path.join(run_dir, "s.bin"), "rb") as f:
            rec, dh = decode_stream(f.read(), device="cpu")
        assert dh.header.K == K
        np.testing.assert_array_equal(rec >> K, world["img"] >> K)
        assert scrape_log(os.path.join(run_dir, "decode.txt"))["psnr"] > 50
