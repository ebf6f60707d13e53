"""The port's workload scripts on the CPU at toy sizes: the flagship
composition (synth -> bucketed dataset encode -> pipelined decode ->
summarize -> Baseline -> BD table) and scale_check, and their refusal to
start without CUDA unless asked for the CPU.

The BD table the port writes must be, character for character, what the
JAX package's bd_table_markdown makes of the port's own CSVs.  At this
size the network's bytes outweigh the scenes, so the BD numbers
themselves are not checked here (the card run at the real shapes is).
"""

import contextlib
import io
import os

import pytest
import torch

from lbdrn_msic_tpu.eval.reports import bd_table_markdown as jbd_table_markdown
from lbdrn_msic_tpu_torch.io.tiff import read_tiff, write_tiff
from lbdrn_msic_tpu_torch.scripts import flagship_workload, scale_check
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

# one scene of each group, as chip_smoke.py runs them
SUBSET = ("GF2_D", "WFI_A", "PMS_A")


def test_flagship_cpu(tmp_path):
    scenes = [(s, c, h // 128, w // 128) for s, c, h, w in flagship_workload.SCENES
              if s in SUBSET]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r = flagship_workload.run(scenes, [3, 4, 5, 6], 1, str(tmp_path), "cpu")
    log = out.getvalue()
    assert r["n_jobs"] == 12 and r["n_lossless"] == 12
    assert "[decode] MSB-lossless 12/12" in log
    groups = {"GF-2": [0], "WFI": [1], "PMS": [2]}
    assert set(r["groups"]) == set(groups)
    for g in r["groups"].values():
        assert g["jobs"] == 4 and g["chunks"] == [[4]] and g["staging"] == ["full"]
    # the plans are the ones encode_dataset ran, one per scene
    assert {s: (p["staging"], p["chunks"]) for s, p in r["plans"].items()} == {
        s: ("full", [[0, 1, 2, 3]]) for s in SUBSET}
    table = jbd_table_markdown({"Baseline": r["baseline_csv"]}, r["results_csv"], 3, groups,
                               k_points=4)
    assert r["table"] == table and table in log
    with open(r["raw"]) as f:
        raw = f.read()
    assert raw.startswith("# FLAGSHIP dress rehearsal") and table in raw
    for path, stem, K in r["bins"]:
        assert os.path.getsize(path) > 0
        assert os.path.exists(os.path.join(os.path.dirname(path), "decode.txt"))
    # a second run resumes every scene whose TIFF has the scene's shape;
    # a TIFF of another shape (a run at another --shrink) is made and
    # encoded anew
    stale = os.path.join(str(tmp_path), "data", "PMS_A.tif")
    write_tiff(stale, synth_scene(24, 40, channels=4, effective_bits=12, seed=1))
    with contextlib.redirect_stdout(io.StringIO()) as again:
        r2 = flagship_workload.run(scenes, [3, 4, 5, 6], 1, str(tmp_path), "cpu")
    assert again.getvalue().count("resume-skip") == 2 and r2["table"] == table
    assert list(r2["plans"]) == ["PMS_A"] and read_tiff(stale).shape == scenes[2][1:]


@pytest.mark.parametrize("mode,want", [
    ([], ["64x64x4 K=5 [cached]", "msb-lossless=True"]),
    (["--dataset", "2", "--K", "3", "4"], ["[cross-image experts]", "[pipelined decode ahead=2]",
                                           "[per-image experts]", "streams verified"]),
])
def test_scale_check_cpu(mode, want):
    argv = ["--sizes", "64", "--channels", "4", "--epochs", "1", "--base-codec", "lpc",
            "--device", "cpu", *mode]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert scale_check.main(argv) == 0
    for w in want:
        assert w in out.getvalue(), (w, out.getvalue())


def test_mains_refuse_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    for main in (flagship_workload.main, scale_check.main):
        with pytest.raises(SystemExit, match="CUDA is not available"):
            main(["--workdir", str(tmp_path)] if main is flagship_workload.main else [])
    assert not os.listdir(tmp_path)  # refused before any work
