"""The port's validation studies (rd_validation, substitute_anchors,
recipe_study, the ablation matrix, repro_all, make_sample) on the CPU at
toy sizes, against the JAX scripts' schema and the JAX evaluation layer.

Tolerances: none.  The host codecs (anchors, substitute codecs) must write
the JAX scripts' CSVs byte for byte on the same inputs; the LBDRN rows
must be what the port's own encoders and `decode_stream` give, character
for character; the BD lines and tables must be, character for character,
what the JAX `bd_report` / `ablation_table_markdown` make of the port's
CSVs.  The JAX scripts' own training is not run (a jit compile a config).
At these sizes the network's bytes outweigh the scenes, so the BD numbers
themselves are not checked here (the card run at the scripts' defaults is).
"""

import contextlib
import csv
import dataclasses
import importlib.util
import io
import os
import sys
import types

import numpy as np
import pytest

from lbdrn_msic_tpu.eval import anchors as janchors
from lbdrn_msic_tpu.eval.reports import ablation_table_markdown as jablation_table_markdown
from lbdrn_msic_tpu.eval.reports import bd_report as jbd_report
from lbdrn_msic_tpu.utils.synth import synth_scene as jsynth_scene
from lbdrn_msic_tpu_torch.codec import decode_stream, encode_pipelined, encode_rate_points
from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
from lbdrn_msic_tpu_torch.scripts import (ablations, make_sample, rd_validation, recipe_study,
                                          repro_all, substitute_anchors)
from lbdrn_msic_tpu_torch.scripts.suite import synth_suite

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_native import ensure_jax_native  # noqa: E402

ensure_jax_native()  # the reference's native library: once per worker, under a lock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Toy-sized tensors gain nothing from intra-op threads; one thread
    keeps these runs from crowding the other test workers' cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(name):
    """The JAX package's scripts/<name>.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _schema(path, names, ks):
    rows = _rows(path)
    assert rows[0] == ["K"] + [f"{n}_{m}" for n in names for m in ("MSE", "PSNR", "bpsp", "bits")]
    assert [r[0] for r in rows[1:]] == [f"K{K}" for K in ks]


def _rd_rows(images, ks, encoded):
    """The canonical CSV rows of (K, scene)-ordered streams, as the JAX
    scripts compute them, from the port's `decode_stream`."""
    from lbdrn_msic_tpu.eval.metrics import PSNR_PEAK

    names, rd = list(images), {}
    for (K, n), stream in encoded.items():
        rec, _ = decode_stream(stream, device="cpu")
        np.testing.assert_array_equal(rec >> K, images[n] >> K)  # MSBs exact
        mse = float(np.mean((images[n].astype(np.float32) - rec.astype(np.float32)) ** 2))
        psnr = 10 * np.log10(PSNR_PEAK**2 / mse) if mse else float("inf")
        rd[(K, n)] = [mse, psnr, 8 * len(stream) / images[n].size, 8 * len(stream)]
    buf = io.StringIO()
    w = csv.writer(buf)
    for K in ks:
        w.writerow([f"K{K}"] + [v for n in names for v in rd[(K, n)]])
    return list(csv.reader(io.StringIO(buf.getvalue())))


def test_suite_is_the_jax_scripts():
    images = synth_suite(32, 2)
    assert list(images) == ["scene0", "scene1"]
    for i, img in enumerate(images.values()):
        np.testing.assert_array_equal(img, jsynth_scene(32, 32, 4, effective_bits=12,
                                                        seed=100 + i))


def test_substitute_anchors_equal_jax(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    args = ["--size", "32", "--scenes", "1", "--in-bits", "10", "12", "--taus", "0", "2"]
    _run(substitute_anchors.main, args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["substitute_anchors.py", *args,
                                      "--out", str(tmp_path / "jax")])
    with contextlib.redirect_stdout(io.StringIO()):
        assert _jax_script("substitute_anchors").main() == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["DLPR_substitute_rd.csv", "JPEGXLsub_11rps.csv", "test_bdr_halfstep.csv"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        assert _read(tmp_path / "port" / n) == _read(tmp_path / "jax" / n), n


def test_variant_matrix_equal_jax():
    jm = _jax_script("ablations").variant_matrix()
    pm = ablations.variant_matrix()
    assert list(pm) == list(jm) == list(ablations.GROUPS)
    n = 0
    for group, (anchor, variants) in pm.items():
        janchor, jvariants = jm[group]
        assert anchor == janchor and list(variants) == list(jvariants)
        for name, kwargs in variants.items():
            assert list(kwargs) == list(jvariants[name])
            for field, spec in kwargs.items():
                ref = jvariants[name][field]
                if dataclasses.is_dataclass(spec):
                    assert dataclasses.asdict(spec) == dataclasses.asdict(ref), (name, field)
                else:
                    assert spec == ref, (name, field)
            n += 1
    assert n == 23


def test_rd_validation_cpu(tmp_path):
    pytest.importorskip("cv2")
    ks = [3, 4, 5, 6]
    out = tmp_path / "rd"
    log = _run(rd_validation.main, ["--size", "32", "--scenes", "2", "--epochs", "1",
                                    "--k-min", "3", "--k-max", "6", "--out", str(out),
                                    "--device", "cpu"])
    images = synth_suite(32, 2)
    names = list(images)
    lbdrn = str(out / "lbdrn_results.csv")
    _schema(lbdrn, names, ks)
    # the LBDRN rows: the port's own encode_pipelined + decode_stream
    cfgs = {K: CodecConfig(K=K, train=TrainSpec(epochs=1, sample_granule=8)) for K in ks}
    tags = [(K, n) for K in ks for n in names]
    encoded = encode_pipelined([(images[n], cfgs[K]) for K, n in tags], device="cpu")
    assert _rows(lbdrn)[1:] == _rd_rows(images, ks, {t: s for t, (s, _) in zip(tags, encoded)})
    # the anchor CSVs: byte for byte the JAX sweep_to_csv's
    for method in rd_validation.ANCHORS:
        path = out / f"{method}_4rps.csv"
        janchors.sweep_to_csv(images, method, str(tmp_path / "ref.csv"), 3, 6)
        assert _read(path) == _read(tmp_path / "ref.csv"), method
        r = jbd_report(str(path), lbdrn, n_images=2, k_points=4)
        line = (f"vs {method:13s}: BD-Rate {r.group_rate['all']:+.3f} %  "
                f"BD-PSNR {r.group_psnr['all']:+.3f} dB")
        assert line in log.splitlines(), line


def test_recipe_study_cpu(tmp_path):
    assert recipe_study.RECIPES == _jax_script("recipe_study").RECIPES
    ks = [5, 6, 7, 8]
    recipes = [("ref_e10", "step", 2), ("cos_e10", "cosine", 2), ("cos_e20", "cosine", 3),
               ("cos_e40", "cosine", 4)]
    with pytest.MonkeyPatch.context() as mp:  # the same study at fewer epochs
        mp.setattr(recipe_study, "RECIPES", recipes)
        log = _run(recipe_study.main, ["--size", "32", "--scenes", "1", "--k-min", "5",
                                       "--k-max", "8", "--base-codec", "lpc",
                                       "--out", str(tmp_path), "--device", "cpu"])
    images = synth_suite(32, 1)
    csvs = {tag: str(tmp_path / "recipe" / f"{tag}.csv") for tag, _, _ in recipes}
    for tag, schedule, epochs in recipes:
        _schema(csvs[tag], ["scene0"], ks)
    tag, schedule, epochs = recipes[2]
    cfgs = [CodecConfig(K=K, base_codec="lpc", train=TrainSpec(
        epochs=epochs, sample_granule=8, schedule=schedule)) for K in ks]
    encoded = encode_pipelined([(images["scene0"], c) for c in cfgs], device="cpu")
    assert _rows(csvs[tag])[1:] == _rd_rows(
        images, ks, {(K, "scene0"): s for K, (s, _) in zip(ks, encoded)})
    with open(tmp_path / "RECIPE.md") as f:
        md = f.read().splitlines()
    assert md[0] == "# Training-recipe study" and "on the CPU." in md[3]
    assert md[7].startswith("| ref_e10 | step | 2 | — | — | ")
    for i, (tag, schedule, epochs) in enumerate(recipes[1:]):
        r = jbd_report(csvs["ref_e10"], csvs[tag], n_images=1, k_points=4)
        cells = (f"| {tag} | {schedule} | {epochs} | {r.group_rate['all']:+.3f} % | "
                 f"{r.group_psnr['all']:+.3f} dB | ")
        assert md[8 + i].startswith(cells), (md[8 + i], cells)
        assert f"{tag}: BD-Rate {r.group_rate['all']:+.3f} %" in log


@pytest.mark.parametrize("group", ablations.GROUPS)
def test_ablations_cpu(tmp_path, group):
    """One group of the matrix: each variant's CSV in the JAX schema, the
    table what the JAX ablation_table_markdown makes of the port's CSVs;
    one variant's rows re-derived from the port's encode_rate_points."""
    ks = [3, 4, 5, 6]
    log = _run(ablations.main, ["--size", "32", "--scenes", "1", "--k-min", "3", "--k-max",
                                "6", "--groups", group, "--base-codec", "lpc",
                                "--out", str(tmp_path), "--device", "cpu"])
    anchor, variants = ablations.variant_matrix()[group]
    csvs = {name: str(tmp_path / f"{group}_{name}.csv") for name in variants}
    for name, path in csvs.items():
        _schema(path, ["scene0"], ks)
        assert f"[{group}] {name}: " in log
    table = jablation_table_markdown({n: p for n, p in csvs.items() if n != anchor},
                                     csvs[anchor], n_images=1, groups={"all": [0]}, k_points=4)
    with open(tmp_path / "ABLATIONS.md") as f:
        md = f.read()
    assert f"## {group} (anchor: {anchor})\n\n{table}\n" in md
    # the last variant (bc256-nl2, sr3, e15, abs-colors-D0): K2 experts
    # where compatible, else one encode_image a K
    name = list(variants)[-1]
    cfg = ablations.variant_config(variants[name], 8, "lpc")
    img = synth_suite(32, 1)
    encoded = encode_rate_points(img["scene0"], [dataclasses.replace(cfg, K=K) for K in ks],
                                 device="cpu")
    assert _rows(csvs[name])[1:] == _rd_rows(
        img, ks, {(K, "scene0"): s for K, (s, _) in zip(ks, encoded)})


def test_ablations_resume_rebuilds_the_jax_record(tmp_path):
    """--resume reuses each variant's CSV instead of sweeping it: over the
    JAX package's committed matrix (validation/ablations/, 256^2, 2
    scenes, K 1..6) the port writes its ABLATIONS.md byte for byte."""
    record = os.path.join(REPO, "validation", "ablations")
    for name in os.listdir(record):
        if name.endswith(".csv"):
            with open(os.path.join(record, name), "rb") as f:
                (tmp_path / name).write_bytes(f.read())
    log = _run(ablations.main, ["--resume", "--out", str(tmp_path), "--device", "cpu"])
    assert log.count(": reusing ") == 23
    assert _read(tmp_path / "ABLATIONS.md") == _read(os.path.join(record, "ABLATIONS.md"))


def test_make_sample_cpu(tmp_path):
    from lbdrn_msic_tpu_torch.io.tiff import read_tiff

    path = str(tmp_path / "d" / "sample.tif")
    _run(make_sample.main, ["--size", "48", "--out", path, "--device", "cpu"])
    np.testing.assert_array_equal(read_tiff(path),
                                  jsynth_scene(48, 48, channels=4, effective_bits=12, seed=42))


def test_multik_ab_cpu():
    """The A/B's rounds on the CPU at a toy size: one warm round, then every
    timed sample printed; each multi_k fits the same network."""
    from lbdrn_msic_tpu_torch.profiling import multik_ab

    fit_k, steps = multik_ab.bench_fit("cpu", 32)
    assert steps == 1
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = multik_ab.ab(fit_k, rounds=2, device="cpu")
    assert [ln.split(":")[0] for ln in out.getvalue().splitlines()] == [
        f"round {r} multi_k={k:>2}" for r in range(2) for k in multik_ab.VARIANTS]
    assert len({res[k]["best_mse"] for k in multik_ab.VARIANTS}) == 1
    assert all(len(res[k]["seconds"]) == 2 for k in multik_ab.VARIANTS)


def test_repro_all_steps(tmp_path, monkeypatch):
    """An unknown step stops the run; `--only bench` runs the port's bench
    with the run's --device; the step table is the JAX script's STEPS in
    full, bench included, and writes under --out."""
    with pytest.raises(SystemExit, match="unknown steps"):
        repro_all.main(["--only", "rd,nope", "--device", "cpu"])
    cmds = []
    monkeypatch.setattr(repro_all.subprocess, "run",
                        lambda cmd, cwd: cmds.append(cmd) or types.SimpleNamespace(returncode=0))
    with contextlib.redirect_stdout(io.StringIO()):
        assert repro_all.main(["--only", "bench", "--device", "cpu"]) == 0
    assert cmds == [[sys.executable, "-m", "lbdrn_msic_tpu_torch.scripts.bench",
                     "--device", "cpu"]]
    jsteps = _jax_script("repro_all").STEPS
    table = repro_all.steps(str(tmp_path))
    assert list(table) == list(jsteps)
    for name, (module, argv) in table.items():
        assert module.startswith("lbdrn_msic_tpu_torch.scripts.")
        jargv = jsteps[name][2:]
        if "--out" in jargv:  # the JAX step's output, under --out
            i = jargv.index("--out")
            want = str(tmp_path / os.path.basename(jargv[i + 1]))
            assert argv[:i] + argv[i + 2:] == jargv[:i] + jargv[i + 2:], name
            assert argv[i + 1] == want, name
        elif name in ("rd", "anchors", "recipe", "ablations"):
            assert argv[-2:][0] == "--out", name
        else:
            assert argv == jargv, name
