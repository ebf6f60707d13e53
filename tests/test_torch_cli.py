"""The port's command lines (`lbdrn_msic_tpu_torch.cli.{encode,decode,
summarize}`) against the JAX package's: the same run directories, log
lines that the reference scraper regexes match, the same CSV, the resume
markers and the v0 warning; the port's refusals (`--mesh`, CUDA absent
without `--device cpu`, jp2 without OpenCV); and v0 streams across the
packages (MSBs exact, residual flips +-1 on at most 0.1 % of the samples:
the parity contract of tests/test_torch_experts.py)."""

import csv
import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

from lbdrn_msic_tpu import codec as jcodec
from lbdrn_msic_tpu.cli import common as jcommon
from lbdrn_msic_tpu.cli import summarize as jsummarize
from lbdrn_msic_tpu.io.header import decode_header as jdecode_header
from lbdrn_msic_tpu_torch import codec
from lbdrn_msic_tpu_torch.cli import common, decode, encode, summarize
from lbdrn_msic_tpu_torch.io.tiff import read_tiff, write_tiff
from lbdrn_msic_tpu_torch.utils.logging import scrape_log
from lbdrn_msic_tpu_torch.utils.synth import synth_scene

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_native import ensure_jax_native  # noqa: E402

ensure_jax_native()  # the reference's native library: once per worker, under a lock

DATA = os.path.join(os.path.dirname(__file__), "data")
HAVE_CV2 = importlib.util.find_spec("cv2") is not None  # the jp2 base codec
FAST = ["-e", "2", "-bs", "2048", "--base-codec", "lpc", "--device", "cpu"]
RUN = "_r1_K5_bc64_nl2_D2_prec16_lr0.001_bs2048_e2"


def _scene(tmp_path, name, seed, h=48, w=48):
    img = synth_scene(h, w, channels=2, seed=seed)
    tif = str(tmp_path / f"{name}.tif")
    write_tiff(tif, img)
    return img, tif


def _flips_ok(a, b):
    diff = a.astype(np.int32) - b.astype(np.int32)
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= 1e-3 * diff.size


def test_encode_decode_summarize_round_trip(tmp_path, capsys):
    """encode -> decode -> summarize through `main(argv)`: the run
    directory, the reference scraper regexes (tests/test_cli.py:92-116),
    MSBs exact, the resume markers, and the CSV the JAX `summarize` writes
    for the same flags."""
    img, tif = _scene(tmp_path, "scene", 21)
    out = str(tmp_path / "out")
    assert encode.main(["-i", tif, "-o", out, "-K", "5"] + FAST) == 0
    run_dir = os.path.join(out, "scene" + RUN)
    bin_path = os.path.join(run_dir, "scene.bin")
    assert os.path.exists(bin_path)
    assert encode.main(["-i", tif, "-o", out, "-K", "5"] + FAST) == 0  # resume marker
    assert "Bitstream already created!" in capsys.readouterr().out

    assert decode.main(["-i", bin_path, "-org", tif, "--keep-recon", "--device", "cpu"]) == 0
    assert decode.main(["-i", bin_path, "-org", tif, "--device", "cpu"]) == 0
    assert "Bitstream already decoded!" in capsys.readouterr().out
    rec = read_tiff(os.path.join(run_dir, "scene_recon.tif"))
    np.testing.assert_array_equal(rec >> 5, img >> 5)

    dec = open(os.path.join(run_dir, "decode.txt")).read()
    enc = open(os.path.join(run_dir, "encode.txt")).read()
    for pat in (r"MSE: (\d+\.\d+)", r"PSNR: (\d+\.\d+)", r"bpsp=(\d+\.\d+)",
                r"Total size: (\d+) bytes", r"Time elapsed: (\d+\.\d+)"):
        assert re.search(pat, dec), pat
    for pat in (r"nn: (\d+) bytes", r"MSB: (\d+) bytes", r"Time elapsed: (\d+\.\d+)",
                r"tile 0: best epoch: \d+ \(MSE: \d+\.\d{5}\)", r"phases: .*train_wait="):
        assert re.search(pat, enc), pat
    got = scrape_log(os.path.join(run_dir, "decode.txt"))
    assert got["psnr"] > 40 and got["bytes"] == os.path.getsize(bin_path)
    assert abs(got["psnr"] - 10 * np.log10(1e8 / np.mean((rec.astype(np.float64) - img) ** 2))) < 1e-3

    argv = ["-i", "scene", "-o", out, "--k-min", "5", "--k-max", "5"] + FAST
    assert summarize.main(argv) == 0
    csv_name = "results_r1_bc64_nl2_D2_prec16_lr0.001_bs2048_e2.csv"
    with open(os.path.join(out, csv_name)) as f:
        ours = list(csv.reader(f))
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    assert jsummarize.main(jargv) == 0  # the JAX scraper over the port's logs
    with open(os.path.join(out, csv_name)) as f:
        theirs = list(csv.reader(f))
    assert ours == theirs
    assert ours[0] == ["K", "scene_MSE", "scene_PSNR", "scene_bpsp", "scene_bits"]
    assert ours[1][0] == "K5" and int(ours[1][4]) == 8 * os.path.getsize(bin_path)


FLAG_SETS = [[], ["-K", "3", "-g", "8", "--schedule", "cosine"], ["-sr", "2", "-bc", "32", "-nl", "3"],
             ["--use-coords", "--embedding", "--no-colors", "-D", "1", "--abs-colors"],
             ["-lr", "0.0005", "-bs", "4096", "-e", "7", "-prec", "12", "--weight-codec", "raw16",
              "--base-codec", "lpc", "--sigma", "2.0", "--n-freq", "6", "-vd", "2"]]


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_flags_and_names_match_jax(flags, tmp_path):
    """`add_codec_args` + `config_from_args` give the JAX package's config
    (field by field), run directory name and CSV name; the port adds
    `--device` (default cuda) and nothing else, to encode and decode."""
    import argparse
    import dataclasses

    def parser(mod, enc=True):
        p = argparse.ArgumentParser()
        mod.add_codec_args(p, encode=enc)
        return p

    dests = lambda p: {x.dest for x in p._actions}
    for enc in (True, False):
        assert dests(parser(common, enc)) == dests(parser(jcommon, enc)) | {"device"}
    a, ja = parser(common).parse_args(flags), parser(jcommon).parse_args(flags)
    assert a.device == "cuda"
    cfg, jcfg = common.config_from_args(a), jcommon.config_from_args(ja)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.run_name("img") == jcfg.run_name("img")
    names = [os.path.basename(mod.summarize(str(tmp_path / mod.__name__), [],
                                            lambda K, c=c: dataclasses.replace(c, K=K), 5, 5))
             for mod, c in ((summarize, cfg), (jsummarize, jcfg))
             if os.makedirs(tmp_path / mod.__name__) is None]
    assert names[0] == names[1]


def test_bench_flags_give_the_bench_config():
    """The card's CLI phase holds `cli.encode -K 5 -g 8 --base-codec lpc`
    byte for byte against `encode_image` at the bench config: the flags
    give exactly that config, seed included."""
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec

    cfg = common.config_from_args(_ns(["-K", "5", "-g", "8"]))
    assert cfg == CodecConfig(K=5, base_codec="lpc", train=TrainSpec(sample_granule=8, epochs=10))
    assert cfg.train.seed == 19920517


def test_v0_warning_mesh_and_device_refusals(tmp_path, capsys, monkeypatch):
    """--header-version 0 warns on stderr (v1 stays quiet) and its stream
    decodes in the JAX package; --mesh without a torch.distributed world
    stops the run naming torchrun (no fallback to one card); without CUDA
    and without --device cpu the run stops with a non-zero exit."""
    img, tif = _scene(tmp_path, "v0", 51)
    out = str(tmp_path / "out")
    assert encode.main(["-i", tif, "-o", out, "-K", "5", "--header-version", "0"] + FAST) == 0
    assert "NOT its body wire format" in capsys.readouterr().err
    assert encode.main(["-i", tif, "-o", out, "-K", "6"] + FAST) == 0
    assert "body wire format" not in capsys.readouterr().err
    # a v0 header has no codec field: the port reads the lpc payload's magic
    stream = open(os.path.join(out, "v0" + RUN, "v0.bin"), "rb").read()
    assert jdecode_header(stream).version == 0
    ours, _ = codec.decode_stream(stream, device="cpu")
    assert np.array_equal(ours >> 5, img >> 5)
    if HAVE_CV2:  # the JAX decoder reads a v0 body as jp2
        jp2 = str(tmp_path / "jp2")
        assert encode.main(["-i", tif, "-o", jp2, "-K", "5", "--header-version", "0"] + FAST
                           + ["--base-codec", "jp2"]) == 0
        stream = open(os.path.join(jp2, "v0" + RUN, "v0.bin"), "rb").read()
        ours, _ = codec.decode_stream(stream, device="cpu")
        theirs, _ = jcodec.decode_stream(stream)
        assert np.array_equal(theirs >> 5, img >> 5)
        _flips_ok(ours, theirs)

    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for main in (encode.main, decode.main):
        args = ["-i", tif, "-o", out] if main is encode.main else ["-i", "x.bin"]
        with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
            main(args + ["--mesh", "dp=2", "--device", "cpu"])
        with pytest.raises(SystemExit, match="bad --mesh axis"):
            main(args + ["--mesh", "sp=2", "--device", "cpu"])
    if not torch.cuda.is_available():
        for main, args in ((encode.main, ["-i", tif, "-o", out, "-K", "4"]),
                           (decode.main, ["-i", "x.bin"])):
            with pytest.raises(SystemExit) as exc:
                main(args)
            assert exc.value.code not in (0, None) and "CUDA" in str(exc.value.code)
        assert not os.path.exists(os.path.join(out, "v0" + RUN.replace("K5", "K4")))


def test_v0_stream_and_golden_cross_decode(tmp_path):
    """The port's `encode_image(header_version=0)` differs from v1 in the
    header only; the committed v0 golden stream (jp2 base) decodes in the
    port to the JAX package's image exactly."""
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.io.header import header_size

    img = synth_scene(40, 44, channels=2, seed=9)
    cfg = CodecConfig(K=5, base_codec="lpc", train=TrainSpec(epochs=1, batch_size=1024))
    v1, _ = codec.encode_image(img, cfg, device="cpu")
    v0, _ = codec.encode_image(img, cfg, header_version=0, device="cpu")
    assert v0[header_size(v0):] == v1[header_size(v1):] and v0 != v1

    if not HAVE_CV2:
        return
    stream = open(os.path.join(DATA, "golden_v0_k5.bin"), "rb").read()
    ours, st = codec.decode_stream(stream, device="cpu")
    theirs, _ = jcodec.decode_stream(stream)
    assert st.header.version == 0 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)  # JAX's image, bit for bit


def test_jp2_without_opencv_names_the_way_out(tmp_path, monkeypatch):
    """A jp2 encode on a machine without OpenCV stops before training with
    an error naming OpenCV and --base-codec lpc (never a silent switch)."""
    _, tif = _scene(tmp_path, "nocv", 3, 32, 32)
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` now raises
    argv = ["-i", tif, "-o", str(tmp_path / "o"), "-e", "1", "--device", "cpu"]
    with pytest.raises(ImportError, match=r"OpenCV.*--base-codec lpc"):
        encode.main(argv)


def test_curves_compile_log_and_randomness(tmp_path, monkeypatch, capsys):
    """--tensorboard collects each tile's per-step losses (and logs the
    JAX line when no writer is importable); --compile-log prints the build
    report and the JAX-shaped compile line; --randomness draws its seed."""
    from lbdrn_msic_tpu_torch.utils import tboard

    img, tif = _scene(tmp_path, "tb", 7, 32, 40)
    cfg = common.config_from_args(_ns(["-e", "2", "-bs", "512"]))
    _, stats = codec.encode_image(img, cfg, collect_curves=True, device="cpu")
    steps = -(-32 * 40 // 512)
    assert stats.tiles[0].step_losses.shape == (2, steps)
    monkeypatch.setattr(tboard, "tensorboard_available", lambda: False)
    out = str(tmp_path / "out")
    assert encode.main(["-i", tif, "-o", out, "--tensorboard", "--compile-log", "-rn"] + FAST) == 0
    enc = open(os.path.join(out, "tb" + RUN, "encode.txt")).read()
    assert "tensorboard writer unavailable; skipping curves" in enc
    assert re.search(r"compile: \d+\.\ds backend over \d+ programs", enc)
    assert "library build log" in capsys.readouterr().err
    assert "randomness=True" in enc


def _ns(flags):
    import argparse

    p = argparse.ArgumentParser()
    common.add_codec_args(p)
    return p.parse_args(flags + ["--base-codec", "lpc"])
