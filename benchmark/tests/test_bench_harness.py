"""The harness finds every part of a cell by name, and a new cell needs
only new files and entries; the window's arithmetic."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness
from traffic import Job

BENCH = harness.BENCH_DIR
ROOT = harness.ROOT
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
TINY = {"scene_rows": 64, "scene_cols": 64, "batch_size": 512, "epochs": 2}


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_workload_resolves_by_name(workload):
    r = harness.resolve(workload)
    assert r["cell"]["name"] == workload
    assert r["traffic"]["entry"] in ("rate_points", "dataset", "image", "decode")
    assert {"bands", "scene_rows", "scene_cols", "epochs"} <= set(r["config"])
    names = [m["name"] for m in r["end_to_end"] + r["per_layer"]]
    assert "setup_s" in names and len(r["end_to_end"]) >= 2 and r["per_layer"]
    for name in names:
        assert callable(harness.reader(name).read)
    assert r["limits"] and all(v >= 0 for v in r["limits"].values())


def test_spec_names_and_paths():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert set(c["reduced"]) <= set(cfg["source_values"])
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                path = os.path.join(d, f)
                out[os.path.relpath(path, root)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def test_new_cell_needs_only_new_files(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell added
    as files and entries in a copy run there; no existing file changes."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    before = _digest(copy / "benchmark")
    b = copy / "benchmark"
    cfg = json.load(open(b / "configs" / "pms4.json"))
    cfg["bands"] = 3
    (b / "configs" / "pms3.json").write_text(json.dumps(cfg))
    (b / "traffic" / "pair.json").write_text(json.dumps(
        {"entry": "rate_points", "ks": [4, 6], "scenes": 1, "sample_jobs": 1}))
    (b / "metrics" / "points_per_job.py").write_text(
        "def read(run):\n    return run.n_points() / len(run.jobs) if run.jobs else None\n")
    (b / "limits" / "pms3.pair.json").write_text(json.dumps(
        {"header_wrong": 0, "msb_wrong": 0, "rows_foreign": 0}))
    spec = json.load(open(copy / "BENCHMARK.json"))
    spec["configs"].append({"name": "pms3", "source": "test", "file": "benchmark/configs/pms3.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "pms3.pair", "config": "pms3", "traffic": "pair",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "points_per_job", "unit": "points", "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "encode_mpx_s", "workloads": ["pms3.pair"]})
    spec["end_to_end"][0]["workloads"].append("pms3.pair")
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys, json, torch; sys.path[:0] = [%r, %r]\n"
        "import harness\n"
        "tiny = %r\n"
        "a = harness.run_cell('pms3.pair', 7, 0.5, False, torch.device('cpu'), overrides=tiny)\n"
        "print(json.dumps([a['result']['correct'], sorted(a['result']['metrics']),"
        " a['run'].n_points()]))\n"
        "harness.resolve('pms3.pair')\n"
        "r = harness.reader('points_per_job')\n"
        "print(r.read(a['run']))\n"
    ) % (str(b), ROOT, dict(TINY, base_codec="lpc"))
    p = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    correct, metrics, points = json.loads(p.stdout.splitlines()[-2])
    assert correct is True
    assert metrics == ["encode_mpx_s", "setup_s"]
    assert float(p.stdout.splitlines()[-1]) == 2.0 and points % 2 == 0
    after = _digest(copy / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


class _Clock:
    def __init__(self):
        self.t = 100.0

    def time(self):
        return self.t


class _FakeMix:
    """Encode jobs of given lengths on a fake clock."""
    entry = "rate_points"
    c = {"scene_rows": 64, "scene_cols": 64, "sample_granule": 8, "batch_size": 512, "epochs": 1}

    def __init__(self, clock, lengths):
        self.clock, self.lengths, self.t = clock, lengths, {}

    def run_encode(self, j, epochs=None):
        t0 = self.clock.t
        self.clock.t += self.lengths[j]
        return Job(j, t0, self.clock.t, [None, None], None)


class _Tap:
    capture = 0
    job = late_from = None
    records = []
    evals = []
    calls = {}


@pytest.mark.parametrize("lengths,seconds,n_jobs,window", [
    ([3, 3, 3, 3, 3], 10, 3, 9),      # the fourth would carry the window past 10
    ([3, 3, 2, 5, 1], 10, 3, 8),      # the fourth starts (8 + 2 <= 10), ends at 13: not counted
    ([12, 1], 10, 1, 12),             # a first job longer than the window still counts
    ([2, 2, 2, 2, 2, 2], 10, 5, 10),  # a job ending at the limit counts
])
def test_whole_job_window(monkeypatch, lengths, seconds, n_jobs, window):
    clock = _Clock()
    monkeypatch.setattr(harness.time, "time", clock.time)
    jobs, t_close, _ = harness.encode_window(_FakeMix(clock, lengths), _Tap(), seconds, None, 1)
    assert len(jobs) == n_jobs
    assert t_close - jobs[0].t0 == pytest.approx(window)
    assert [j.index for j in jobs] == list(range(n_jobs))


def test_idle_gaps_by_innermost_host_span():
    dev = [("k", 1.0, 2.0), ("k", 1.5, 3.0), ("k", 6.0, 7.0)]
    spans = [("job:0", 0.0, 8.0), ("phase:dispatch", 0.0, 4.0), ("phase:train_wait", 4.0, 8.0)]
    gaps = dict(harness.idle_gaps(dev, (0.0, 10.0), spans))
    assert gaps == {"dispatch": 1.0, "train_wait": 3.0, "between jobs": 3.0}


def test_raw_profiler_events_keep_labels_and_times():
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function("job:0"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    prof.stop()
    evs = list(harness.raw_events(prof))
    job = [e for e in evs if e[0] == "job:0"]
    assert len(job) == 1 and job[0][1] == torch.autograd.DeviceType.CPU
    assert 0 <= job[0][2] < job[0][3]
    inner = [e for e in evs if e[0].startswith("aten::") and job[0][2] <= e[2] <= e[3] <= job[0][3]]
    assert inner
