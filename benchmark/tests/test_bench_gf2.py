"""The whole-scene cell `gf2.encode` at a CPU size, and the readers of
`base_code_s`, `stage_ms` and `staged_gb`.

The cell runs with the tiny sizes of the other harness tests, a width
that is no multiple of the granule (as GF-2's 7815 columns) and the
staging budget shrunk between the "full" tap matrix and the f32 feature
cache, so that the fit stages "full" taps as it does at GF-2 size."""

import types

import pytest
import torch

import harness
from traffic import Job, Point

TINY = {"scene_rows": 64, "scene_cols": 64, "batch_size": 512, "epochs": 2}
CFG = {"bands": 4, "D": 2, "base_channel": 64, "num_layers": 2, "batch_size": 8192,
       "scene_rows": 7605, "scene_cols": 7815, "epochs": 10}


def test_gf2_encode_reads_correct_on_full_staging(monkeypatch):
    from lbdrn_msic_tpu_torch import codec
    from lbdrn_msic_tpu_torch.core.config import FeatureSpec

    H, W = 64, 45
    cache = codec._cached_bytes(H, W, 4, FeatureSpec(), 8)
    monkeypatch.setattr(codec, "STAGE_BUDGET_BYTES", cache - 1)
    out = harness.run_cell("gf2.encode", 2**31 + 11, 0.5, True, torch.device("cpu"),
                           overrides=dict(TINY, scene_cols=W))
    res = out["result"]
    assert res["correct"] is True, res["checks"]
    tiles = [p.stats.tiles[0] for j in out["run"].jobs for p in j.points]
    assert {t.staging for t in tiles} == {"full"}
    assert res["metrics"]["staged_gb"]["value"] == pytest.approx(-(-H * W // 8) * 8 * 4 * 25 / 1e9)
    assert res["metrics"]["base_code_s"]["value"] > 0
    assert "stage_ms" not in res["metrics"]  # a device span: none on the CPU


def _stats(nbytes):
    return types.SimpleNamespace(tiles=[types.SimpleNamespace(staged_bytes=nbytes)])


def _run(phases, points=(1, 1), entry="image", nbytes=5_943_308_000):
    jobs = [Job(i, 0, 1, [Point(0, 5, b"", _stats(nbytes)) for _ in range(n)],
                None if phases is None else dict(phases)) for i, n in enumerate(points)]
    return harness.Run("x", {}, CFG, {"entry": entry}, "NVIDIA H100 80GB HBM3", jobs, 10.0,
                       5.0, None, None, {})


@pytest.mark.parametrize("name,phases,want", [
    ("base_code_s", {"base_code": 3.0, "base_wait": 0.5}, 1.5),
    ("stage_ms", {"stage": 0.4, "stage_device": 0.25}, 125.0),
])
def test_span_readers(name, phases, want):
    r = harness.reader(name)
    assert r.read(_run(phases, points=(2, 2))) == pytest.approx(want)
    # the parent's phases, or none: nothing to read
    assert r.read(_run({"dispatch": 3.0, "base_wait": 0.5, "stage": 0.4})) is None
    assert r.read(_run(None)) is None


def test_staged_gb_reader():
    r = harness.reader("staged_gb")
    assert r.read(_run(None)) == pytest.approx(5.943308)  # GF-2 at K 5: "full" int8 taps
    assert r.read(_run(None, entry="decode")) is None
    bare = harness.Run("x", {}, CFG, {"entry": "image"}, "cpu",
                       [Job(0, 0, 1, [Point(0, 5, b"")], None)], 1.0, 1.0, None, None, {})
    assert r.read(bare) is None
