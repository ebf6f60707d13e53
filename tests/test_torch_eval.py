"""The port's evaluation layer against the JAX package's: BD metrics,
reports and the classical anchors.

Tolerances: none.  BD numbers, table text, anchor bitstreams, their
decodes and the sweep CSVs must be equal exactly (the two packages run the
same numpy / scipy / OpenCV code on the same inputs).  Inputs: the
committed validation/*.csv and seeded synthetic scenes.
"""

import glob
import os
import shutil
import sys

import numpy as np
import pytest

from lbdrn_msic_tpu.eval import anchors as janchors
from lbdrn_msic_tpu.eval import metrics as jmetrics
from lbdrn_msic_tpu.eval import reports as jreports
from lbdrn_msic_tpu_torch.eval import anchors, metrics, reports
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_native import ensure_jax_native  # noqa: E402

ensure_jax_native()  # the reference's native library: once per worker, under a lock

VAL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "validation")
ANCHOR_CSVS = {m: os.path.join(VAL, f"{m}_6rps.csv")
               for m in ("Baseline", "JPEG2000star", "JPEG2000")}
TEST_CSVS = [os.path.join(VAL, n) for n in ("lbdrn_results.csv", "lbdrn_results_g1.csv")]
GROUPS = {"first": [0, 1], "last": [2]}
ABLATIONS = sorted(glob.glob(os.path.join(VAL, "ablations", "*.csv")))


@pytest.mark.parametrize("piecewise", [False, True])
def test_bd_metrics_equal_jax(piecewise):
    n = 0
    for anchor in ANCHOR_CSVS.values():
        a_psnr, a_bits, _ = jreports.read_results_csv(anchor, 3)
        for test in TEST_CSVS:
            t_psnr, t_bits, _ = jreports.read_results_csv(test, 3)
            for i in range(3):
                args = (a_bits[i], a_psnr[i], t_bits[i], t_psnr[i])
                for port_fn, jax_fn in ((metrics.bd_rate, jmetrics.bd_rate),
                                        (metrics.bd_psnr, jmetrics.bd_psnr)):
                    got = port_fn(*args, piecewise=piecewise)
                    assert got == jax_fn(*args, piecewise=piecewise), (anchor, test, i)
                    assert np.isfinite(got)
                    n += 1
    assert n == 36


@pytest.mark.parametrize("last,k_points", [(False, 6), (True, 4)])
def test_reports_equal_jax(last, k_points):
    """read_results_csv, bd_report (both fit modes), bd_table_markdown and
    ablation_table_markdown (markdown and LaTeX) give JAX's numbers and
    text."""
    for path in TEST_CSVS + list(ANCHOR_CSVS.values()):
        for got, ref in zip(reports.read_results_csv(path, 3, k_points, last),
                            jreports.read_results_csv(path, 3, k_points, last)):
            assert np.array_equal(got, ref)
    for piecewise in (False, True):
        got = reports.bd_report(ANCHOR_CSVS["Baseline"], TEST_CSVS[0], 3, k_points, GROUPS,
                                piecewise, last)
        ref = jreports.bd_report(ANCHOR_CSVS["Baseline"], TEST_CSVS[0], 3, k_points, GROUPS,
                                 piecewise, last)
        assert vars(got) == vars(ref)
    for fmt in ("markdown", "latex"):
        for test in TEST_CSVS:
            got = reports.bd_table_markdown(ANCHOR_CSVS, test, 3, GROUPS, k_points, last, fmt)
            assert got == jreports.bd_table_markdown(ANCHOR_CSVS, test, 3, GROUPS, k_points,
                                                     last, fmt)
        variants = {os.path.basename(p)[:-4]: p for p in ABLATIONS}
        anchor = os.path.join(VAL, "ablations", "training_lr1e-3-bs8192-e10.csv")
        got = reports.ablation_table_markdown(variants, anchor, 2, {"all": [0, 1]}, k_points,
                                              last, fmt)
        assert got == jreports.ablation_table_markdown(variants, anchor, 2, {"all": [0, 1]},
                                                       k_points, last, fmt)
        assert got.count("\n") >= len(variants)
    with pytest.raises(ValueError, match="rate rows"):
        reports.read_results_csv(TEST_CSVS[0], 3, 7)


def test_error_stats_and_rd_plot(tmp_path):
    org = synth_scene(32, 40, channels=3, seed=50)
    recons = {"drop2": ((org >> 2) << 2).astype(np.uint16), "exact": org,
              "noisy": np.clip(org.astype(np.int64) + (np.arange(org.size) % 7 - 3).reshape(
                  org.shape), 0, 65535).astype(np.uint16)}
    for fmt in ("markdown", "latex"):
        assert reports.error_stats_table(org, recons, fmt=fmt) == \
            jreports.error_stats_table(org, recons, fmt=fmt)
    pytest.importorskip("matplotlib")
    png = reports.rd_plot({"lbdrn": TEST_CSVS[0], **ANCHOR_CSVS}, 1, str(tmp_path / "rd.png"), 3)
    assert os.path.getsize(png) > 1000


@pytest.mark.parametrize("method", ["Baseline", "JPEG2000star", "JPEG2000"])
def test_anchor_streams_equal_jax(method):
    pytest.importorskip("cv2")
    img = synth_scene(96, 80, channels=4, effective_bits=12, seed=31)
    for K in (1, 5):
        stream = anchors.anchor_encode(img, method, K)
        assert stream == janchors.anchor_encode(img, method, K), (method, K)
        rec = anchors.anchor_decode(stream, method)
        assert rec.dtype == np.uint16
        assert np.array_equal(rec, janchors.anchor_decode(stream, method))
        assert anchors.eval_rd(img, stream, rec) == janchors.eval_rd(img, stream, rec)
        if method == "Baseline":
            assert np.array_equal(rec, (img >> K) << K)


def test_sweep_to_csv_equal_jax(tmp_path):
    """The anchor sweep's CSV, byte for byte: Baseline over two scenes, and
    the JPEG XL slot with the in-repo substitute band codec."""
    pytest.importorskip("cv2")
    imgs = {"a": synth_scene(48, 48, channels=2, effective_bits=12, seed=34),
            "b": synth_scene(40, 56, channels=3, effective_bits=12, seed=35)}
    cases = [("Baseline", None, None), ("JPEGXL", anchors.jxl_substitute_band_codec(),
                                        janchors.jxl_substitute_band_codec())]
    for method, codec, jcodec in cases:
        got = anchors.sweep_to_csv(imgs, method, str(tmp_path / f"{method}.csv"), 3, 5,
                                   jxl_band_codec=codec)
        ref = janchors.sweep_to_csv(imgs, method, str(tmp_path / f"j{method}.csv"), 3, 5,
                                    jxl_band_codec=jcodec)
        with open(got) as f, open(ref) as g:
            text = f.read()
            assert text == g.read(), method
        assert text.splitlines()[0].startswith("K,a_MSE,a_PSNR,a_bpsp,a_bits,b_MSE")


def test_jpegxl_gate_equal_jax(monkeypatch):
    """Without cjxl/djxl both packages refuse the JPEG XL anchor with the
    same error; with them on PATH both report it available."""
    assert anchors.jpegxl_available() == janchors.jpegxl_available()
    img = synth_scene(32, 32, channels=1, seed=33)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    for mod in (anchors, janchors):
        assert not mod.jpegxl_available()
        with pytest.raises(RuntimeError, match="cjxl/djxl not found") as enc_err:
            mod.anchor_encode(img, "JPEGXL", K=1)
        with pytest.raises(RuntimeError, match="cjxl/djxl not found") as dec_err:
            mod.anchor_decode(b"\x02\x01", "JPEGXL")
        assert str(enc_err.value) == str(dec_err.value)
    monkeypatch.setattr(shutil, "which", lambda name: f"/usr/bin/{name}")
    assert anchors.jpegxl_available() and janchors.jpegxl_available()
    with pytest.raises(ValueError, match="unknown anchor method"):
        anchors.anchor_encode(img, "JPEG", K=1)
