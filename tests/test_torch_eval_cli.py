"""The port's evaluation command lines (cli.anchors, cli.report,
cli.visualize) against the JAX package's, flag for flag, on the same
inputs: the same files, the same bytes, the same printed text (output
directories aside).  Host work only: none of the three touches a device.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

from lbdrn_msic_tpu.cli import anchors as janchors_cli
from lbdrn_msic_tpu.cli import report as jreport_cli
from lbdrn_msic_tpu.cli import visualize as jvisualize_cli
from lbdrn_msic_tpu_torch.cli import anchors as anchors_cli
from lbdrn_msic_tpu_torch.cli import report as report_cli
from lbdrn_msic_tpu_torch.cli import visualize as visualize_cli
from lbdrn_msic_tpu_torch.io.tiff import write_tiff
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_native import ensure_jax_native  # noqa: E402

ensure_jax_native()  # the reference's native library: once per worker, under a lock

VAL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "validation")


def _main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _files(d):
    got = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            got[name] = f.read()
    return got


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    paths = {}
    for name, (h, w, c, seed) in {"a": (48, 40, 4, 61), "b": (40, 56, 3, 62)}.items():
        paths[name] = str(d / f"{name}.tif")
        write_tiff(paths[name], synth_scene(h, w, channels=c, effective_bits=12, seed=seed))
    return paths


def test_anchors_cli_equal_jax(tmp_path, scenes):
    pytest.importorskip("cv2")
    for flags in (["--jxl-substitute"], []):
        argv = ["-i", scenes["a"], scenes["b"], "-m", "Baseline", "JPEG2000star", "JPEG2000",
                "JPEGXL", "--k-min", "3", "--k-max", "4", *flags]
        out = {}
        for name, main in (("port", anchors_cli.main), ("jax", janchors_cli.main)):
            d = str(tmp_path / f"{name}{len(flags)}")
            rc, printed = _main(main, argv + ["-o", d])
            assert rc == 0
            out[name] = (printed.replace(d, "<out>"), _files(d))
        assert out["port"] == out["jax"]
        names = set(out["port"][1])
        if flags:
            assert names == {f"{m}_2rps.csv" for m in
                             ("Baseline", "JPEG2000star", "JPEG2000", "JPEGXLsub")}
        else:
            assert "JPEGXL" not in "".join(names) and "skipping JPEGXL" in out["port"][0]


@pytest.mark.parametrize("flags", [
    ["-g", "first=0-1", "last=2-2"],
    ["-k", "4", "--last", "--latex"],
])
def test_report_cli_equal_jax(tmp_path, flags):
    pytest.importorskip("matplotlib")
    argv = ["-t", os.path.join(VAL, "lbdrn_results.csv"), "-n", "3", "-a",
            f"Baseline={VAL}/Baseline_6rps.csv", f"JPEG2000={VAL}/JPEG2000_6rps.csv", *flags]
    out = {}
    for name, main in (("port", report_cli.main), ("jax", jreport_cli.main)):
        d = str(tmp_path / name)
        rc, printed = _main(main, argv + ["--plot-dir", d])
        assert rc == 0
        out[name] = (printed.replace(d, "<plots>"), sorted(os.listdir(d)))
    assert out["port"] == out["jax"]
    assert out["port"][1] == ["rd_image0.png", "rd_image1.png", "rd_image2.png"]
    assert ("BD-Rate" in out["port"][0]) and ("tabular" in out["port"][0]) == ("--latex" in flags)


def test_visualize_cli_equal_jax(tmp_path, scenes):
    """The same figures under the same names; the composites byte for byte
    (plt.imsave of equal arrays); a bad band stops both."""
    pytest.importorskip("matplotlib")
    from lbdrn_msic_tpu_torch.io.tiff import read_tiff

    img = read_tiff(scenes["a"])
    rec = str(tmp_path / "rec.tif")
    write_tiff(rec, ((img >> 3) << 3).astype(np.uint16))
    for argv in (["-i", scenes["a"], "--msb-lsb", "5", "--band", "1", "--recon", f"drop3={rec}"],
                 ["-i", scenes["b"], "--bands", "2", "0", "1"]):
        out = {}
        for name, main in (("port", visualize_cli.main), ("jax", jvisualize_cli.main)):
            d = str(tmp_path / name / str(len(argv)))
            rc, printed = _main(main, argv + ["-o", d])
            assert rc == 0
            out[name] = (printed.replace(d, "<out>"), _files(d))
        assert out["port"][0] == out["jax"][0]
        assert out["port"][1].keys() == out["jax"][1].keys()
        for f, data in out["port"][1].items():
            assert len(data) > 500
            if "composite" in f or f.endswith(("_true.png", "_false.png")):
                assert data == out["jax"][1][f], f
    for main in (visualize_cli.main, jvisualize_cli.main):
        with pytest.raises(SystemExit, match="out of range"):
            _main(main, ["-i", scenes["b"], "--band", "3", "-o", str(tmp_path / "bad")])
