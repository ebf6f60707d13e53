"""The port's sweep command line (`lbdrn_msic_tpu_torch.cli.sweep`) and its
job scheduler against the JAX package's (tests/test_cli.py:46-135,
tests/test_distributed.py:16-60): the per-job, `--pipeline` and
`--batch-experts` modes give the same streams; the run directories, their
files and their log lines are the JAX `cli.sweep`'s on the same inputs and
flags, `--hosts` / `--host-id` partitions included; a rerun resumes
without training; `--mesh` without a world and `--distributed` with
`--mesh` stop the run."""

import os
import re
import sys

import numpy as np
import pytest
import torch

from lbdrn_msic_tpu.cli import sweep as jsweep
from lbdrn_msic_tpu.parallel.distributed import JobScheduler as JJobScheduler
from lbdrn_msic_tpu_torch import codec
from lbdrn_msic_tpu_torch.cli import sweep
from lbdrn_msic_tpu_torch.eval.metrics import psnr
from lbdrn_msic_tpu_torch.io.tiff import read_tiff, write_tiff
from lbdrn_msic_tpu_torch.parallel.distributed import JobScheduler
from lbdrn_msic_tpu_torch.train import loop
from lbdrn_msic_tpu_torch.utils.logging import scrape_log
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_native import ensure_jax_native  # noqa: E402

ensure_jax_native()  # the reference's native library: once per worker, under a lock

FLAGS = ["--k-min", "4", "--k-max", "5", "-e", "1", "-bs", "1024", "--base-codec", "lpc"]
CPU = ["--device", "cpu"]
MODES = {"per_job": [], "pipeline": ["--pipeline"], "batch_experts": ["--batch-experts"]}
RUN = "_r1_K{}_bc64_nl2_D2_prec16_lr0.001_bs1024_e1"


@pytest.fixture(scope="module")
def tifs(tmp_path_factory):
    """Two 48x40x2 scenes of one shape, written as TIFFs."""
    d = tmp_path_factory.mktemp("tifs")
    paths = []
    for name, seed in (("a", 41), ("b", 42)):
        path = str(d / f"{name}.tif")
        write_tiff(path, synth_scene(48, 40, channels=2, seed=seed))
        paths.append(path)
    return paths


def _streams(out):
    """{run dir name: stream bytes} under an output directory."""
    got = {}
    for run in sorted(os.listdir(out)):
        stem = run.split("_r1_")[0]
        with open(os.path.join(out, run, stem + ".bin"), "rb") as f:
            got[run] = f.read()
    return got


def test_job_scheduler_matches_jax():
    """tests/test_distributed.py:16-60: the partition is the JAX
    scheduler's, disjoint and complete; `done` skips; retries re-run a
    transient failure and raise a persistent one, skipping a job that
    completed between attempts."""
    jobs = [f"j{i}" for i in range(10)]
    for n in (1, 2, 3, 4):
        shards = [JobScheduler(n, p).mine(jobs) for p in range(n)]
        assert shards == [JJobScheduler(n, p).mine(jobs) for p in range(n)]
        assert sorted(sum(shards, [])) == sorted(jobs)
    assert JobScheduler().run(["a", "b", "c"], lambda j: None, done=lambda j: j == "a") == \
        ["b", "c"]
    attempts = {}

    def flaky(j):
        attempts[j] = attempts.get(j, 0) + 1
        if j == "b" and attempts[j] < 3:
            raise RuntimeError("transient")

    assert JobScheduler().run(["a", "b"], flaky, retries=2) == ["a", "b"]
    assert attempts == {"a": 1, "b": 3}
    with pytest.raises(ZeroDivisionError):
        JobScheduler().run(["c"], lambda j: 1 / 0, retries=1)
    state = {"n": 0, "done": False}

    def once(j):
        state["n"] += 1
        state["done"] = True
        raise RuntimeError("died after completing")

    assert JobScheduler().run(["x"], once, done=lambda j: state["done"], retries=1) == ["x"]
    assert state["n"] == 1
    with pytest.raises(ValueError):
        JobScheduler().run(["x"], lambda j: None, retries=-1)


def test_sweep_modes_give_the_same_streams(tifs, tmp_path):
    """The per-job, pipelined and expert-batched modes write the same run
    directories and the same stream bytes (each `encode_image`'s), and
    every decode log's PSNR is the stream's."""
    got = {}
    for mode, extra in MODES.items():
        out = str(tmp_path / mode)
        assert sweep.main(["-i", *tifs, "-o", out, *FLAGS, *CPU, *extra]) == 0
        got[mode] = _streams(out)
    assert sorted(got["per_job"]) == sorted(f"{s}{RUN.format(K)}" for s in "ab" for K in (4, 5))
    assert got["pipeline"] == got["per_job"] == got["batch_experts"]
    for run, stream in got["batch_experts"].items():
        rec, _ = codec.decode_stream(stream, device="cpu")
        K = int(run.split("_K")[1].split("_")[0])
        img = read_tiff(tifs["ab".index(run[0])])
        assert np.array_equal(rec >> K, img >> K)
        log = scrape_log(os.path.join(tmp_path / "batch_experts", run, "decode.txt"))
        assert abs(log["psnr"] - psnr(img, rec)) < 1e-9 and log["bytes"] == len(stream)


def test_sweep_resume_trains_nothing(tifs, tmp_path, monkeypatch, capsys):
    """A rerun of a finished sweep finds every resume marker: no fit, no
    decode, in each mode."""
    outs = {}
    for mode, extra in MODES.items():
        outs[mode] = str(tmp_path / mode)
        assert sweep.main(["-i", *tifs, "-o", outs[mode], *FLAGS, *CPU, *extra]) == 0

    def refuse(*a, **k):
        raise AssertionError("a resumed sweep trained or decoded")

    for mod, name in ((loop, "fit"), (loop, "fit_rate_experts"), (codec, "fit"),
                      (codec, "fit_rate_experts"), (codec, "decode_stream"),
                      (codec, "decode_pipelined_iter")):
        monkeypatch.setattr(mod, name, refuse)
    capsys.readouterr()
    for mode, extra in MODES.items():
        assert sweep.main(["-i", *tifs, "-o", outs[mode], *FLAGS, *CPU, *extra]) == 0
    out = capsys.readouterr().out
    assert out.count("Bitstream already created!") == 4
    assert out.count("Bitstream already decoded!") == 4
    assert "encode of" not in out and "decoded" not in out.replace("already decoded", "")


def _log_keys(path, out):
    """A log's lines with the timestamp dropped, the output directory and
    every number masked, and the argument dump reduced to its name."""
    keys = []
    for line in open(path).read().splitlines():
        msg = line.split("] ", 1)[1]
        if msg.startswith("Namespace("):
            keys.append("Namespace")
            continue
        msg = msg.replace(out, "OUT")
        keys.append(re.sub(r"-?\d[\d.]*(e[-+]?\d+)?", "#", msg))
    return keys


@pytest.mark.parametrize("mode", list(MODES))
def test_sweep_dirs_and_logs_match_jax(mode, tifs, tmp_path, capsys):
    """tests/test_cli.py:46-135 on both packages, `--hosts 2 --host-id 1`:
    the same run directories (the host's share: (path, K) jobs 1 and 3
    per job, the second image with experts), the same files in each, the
    same log lines up to numbers, and the same sweep messages."""
    extra = MODES[mode] + ["--hosts", "2", "--host-id", "1"]
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jsweep.main(["-i", *tifs, "-o", jout, *FLAGS, *extra]) == 0
    jmsgs = [m for m in capsys.readouterr().out.splitlines() if m.startswith("[sweep]")]
    assert sweep.main(["-i", *tifs, "-o", pout, *FLAGS, *CPU, *extra]) == 0
    pmsgs = [m for m in capsys.readouterr().out.splitlines() if m.startswith("[sweep]")]
    assert [re.sub(r"[\d.]+s$", "#s", m) for m in pmsgs] == \
        [re.sub(r"[\d.]+s$", "#s", m) for m in jmsgs]
    runs = sorted(os.listdir(pout))
    assert runs == sorted(os.listdir(jout))
    want = ([f"a{RUN.format(5)}", f"b{RUN.format(5)}"] if mode != "batch_experts"
            else [f"b{RUN.format(K)}" for K in (4, 5)])
    assert runs == want
    for run in runs:
        assert sorted(os.listdir(os.path.join(pout, run))) == \
            sorted(os.listdir(os.path.join(jout, run)))
        for log in ("encode.txt", "decode.txt"):
            assert _log_keys(os.path.join(pout, run, log), pout) == \
                _log_keys(os.path.join(jout, run, log), jout), (run, log)


def test_sweep_refusals(tifs, tmp_path, monkeypatch):
    """`--mesh` without a torch.distributed world stops the run naming
    torchrun; `--distributed` with `--mesh` stops it saying why one world
    cannot do both; a host id out of range stops it; without CUDA and
    `--device cpu` it stops before any work.  (`--mesh` under a world:
    tests/test_torch_mesh_cli.py.)"""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    out = str(tmp_path / "out")
    for extra in (["--mesh", "ep=2"], ["--mesh", "ep=2", "--pipeline"]):
        with pytest.raises(SystemExit, match="torchrun"):
            sweep.main(["-i", *tifs, "-o", out, *FLAGS, *CPU, *extra])
    for extra in (["--distributed", "--mesh", "ep=2"],
                  ["--distributed", "--mesh", "dp=2", "--batch-experts"]):
        with pytest.raises(SystemExit, match="cannot share one world"):
            sweep.main(["-i", *tifs, "-o", out, *FLAGS, *CPU, *extra])
    with pytest.raises(SystemExit, match="host-id"):
        sweep.main(["-i", *tifs, "-o", out, *FLAGS, *CPU, "--hosts", "2", "--host-id", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            sweep.main(["-i", *tifs, "-o", out, *FLAGS])
    assert not os.path.exists(out)
