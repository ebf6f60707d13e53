"""Dress rehearsal: the reference's FULL experiment at real dataset shapes,
on the port.

The reference's actual workload is 13 Gaofen scenes x K=1..6 through
encode -> decode -> results CSV -> BD report (reference run.sh:29-40,
results_summary.py:79-137, BD_metrics.py SOTA()).  The real scenes are
git-LFS-absent, so this synthesizes the suite at the REAL shapes
(reference DLPR_nll_results.py:89-103: 3x GF-2 7340x7815x4,
2x GF-2 7605x7815x4, 4x GF-6 WFI 6000^2x8, 4x GF-6 PMS 6000^2x4) and runs
the whole composition once, end to end, with the fastest modes (cross-image
expert batching + shape bucketing + LLPC v2 base codec + pipelined
decode):

    python -m lbdrn_msic_tpu_torch.scripts.flagship_workload --workdir DIR
    python -m lbdrn_msic_tpu_torch.scripts.flagship_workload --device cpu \\
        --shrink 128 --k-min 3 --k-max 6 --epochs 1 --workdir DIR   # a CPU smoke run

Phases (each timed; the library builds reported):
  1. synth       - write the 13 synthetic TIFFs (kept where present at
                   the scene's shape)
  2. encode      - `encode_dataset(jobs, bucket=True)`, one resumable scene
                   at a time (K2 on the card), with each scene's staging
                   mode and chunk plan
  3. decode      - `decode_pipelined_iter` over the streams, verifying
                   every stream MSB-lossless and logging reference-format
                   decode.txt metrics
  4. summarize   - cli.summarize -> canonical results CSV
  5. report      - BD-Rate/BD-PSNR vs the Baseline anchor per group
                   (GF-2 / WFI / PMS).  Baseline = drop-LSB + the SAME
                   lossless base coder as the run (bits = base stream,
                   PSNR of (msb << K)) — the reference's Baseline uses
                   GDAL-JP2 (SOTA.py:41-64); with --base-codec lpc the
                   base layer costs a few % more bytes, which UNDERSTATES
                   the BD gain against a JP2 baseline.

Writes <workdir>/FLAGSHIP_raw.md with every measured number.  `run` is the
same composition as a function (chip_smoke.py calls it on a subset of
SCENES).  `--device` defaults to cuda; the run stops without CUDA unless
given `--device cpu`.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys
import time

import numpy as np
import torch

# (stem, channels, H, W) — reference DLPR_nll_results.py:89-103 shapes
SCENES = [
    ("GF2_A", 4, 7340, 7815),
    ("GF2_B", 4, 7340, 7815),
    ("GF2_C", 4, 7340, 7815),
    ("GF2_D", 4, 7605, 7815),
    ("GF2_E", 4, 7605, 7815),
    ("WFI_A", 8, 6000, 6000),
    ("WFI_B", 8, 6000, 6000),
    ("WFI_C", 8, 6000, 6000),
    ("WFI_D", 8, 6000, 6000),
    ("PMS_A", 4, 6000, 6000),
    ("PMS_B", 4, 6000, 6000),
    ("PMS_C", 4, 6000, 6000),
    ("PMS_D", 4, 6000, 6000),
]
GROUPS = ["GF-2=0-4", "WFI=5-8", "PMS=9-12"]


def scene_seed(stem: str) -> int:
    """Each scene's synth seed, by its index in SCENES (the JAX script's
    500 + i), so that a subset of SCENES synthesizes the same images."""
    return 500 + [s for s, _, _, _ in SCENES].index(stem)


def scene_groups(stems):
    """GROUPS over the scenes run, by stem: label -> indices in `stems`."""
    all_stems = [s for s, _, _, _ in SCENES]
    groups = {}
    for spec in GROUPS:
        name, rng = spec.split("=")
        lo, hi = (int(x) for x in rng.split("-"))
        idx = [i for i, s in enumerate(stems) if lo <= all_stems.index(s) <= hi]
        if idx:
            groups[name] = idx
    return groups


def run(scenes, ks, epochs, workdir, device=None, granule=8, base_codec="lpc"):
    """The flagship composition on `scenes` ((stem, C, H, W) rows of
    SCENES, possibly shrunk) at rate points `ks`: synth, per-scene
    `encode_dataset(bucket=True)`, `decode_pipelined_iter`, summarize,
    the Baseline CSV and the BD table, all under `workdir`.  Prints the log
    lines and writes them to <workdir>/FLAGSHIP_raw.md.  `device=None`
    means CUDA.  Returns a dict of what it measured: the images, the
    bitstream paths, MSB-lossless count, per-group staging / chunk plans /
    seconds a job, each encoded scene's group plan as `encode_dataset`
    ran it and (on CUDA) its encode's peak device memory, allocated and
    reserved (`scene_peaks`), the CSVs, the BD report per group, the
    table."""
    from lbdrn_msic_tpu_torch import codec, resolve_device
    from lbdrn_msic_tpu_torch.cli.encode import write_encode_outputs
    from lbdrn_msic_tpu_torch.cli.summarize import summarize
    from lbdrn_msic_tpu_torch.core.config import CodecConfig, TrainSpec
    from lbdrn_msic_tpu_torch.eval.metrics import PSNR_PEAK
    from lbdrn_msic_tpu_torch.eval.reports import bd_report, bd_table_markdown
    from lbdrn_msic_tpu_torch.io.tiff import read_tiff, write_tiff
    from lbdrn_msic_tpu_torch.utils.build_log import BuildLog
    from lbdrn_msic_tpu_torch.utils.logging import RunLogger
    from lbdrn_msic_tpu_torch.utils.synth import synth_scene

    device = resolve_device(device)
    cuda = device.type == "cuda"
    wd = workdir
    data_dir = os.path.join(wd, "data")
    run_root = os.path.join(wd, "runs")
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(run_root, exist_ok=True)
    lines = [
        "# FLAGSHIP dress rehearsal (raw numbers)", "",
        f"scenes={len(scenes)} K={ks[0]}..{ks[-1]} "
        f"epochs={epochs} base_codec={base_codec} "
        f"granule={granule} device={device}"
        + (f" ({torch.cuda.get_device_name(device)})" if cuda else ""), "",
    ]

    def log(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    # --- phase 1: synthesize the suite at the real shapes ---------------
    # A TIFF left by an earlier run is reused only at its scene's shape
    # (a run at another --shrink leaves other shapes); a scene made anew
    # is encoded anew, whatever bins it has.
    t0 = time.time()
    imgs = {}
    made = set()
    for stem, c, h, w in scenes:
        path = os.path.join(data_dir, f"{stem}.tif")
        if os.path.exists(path):
            imgs[stem] = read_tiff(path)
        if stem not in imgs or imgs[stem].shape != (c, h, w):
            imgs[stem] = synth_scene(
                h, w, channels=c, effective_bits=12, seed=scene_seed(stem),
                fast=True,
            )
            write_tiff(path, imgs[stem])
            made.add(stem)
    log(f"[synth] {len(scenes)} scenes in {time.time() - t0:.1f}s "
        f"({sum(im.nbytes for im in imgs.values()) / 1e9:.2f} GB)")

    tspec = TrainSpec(epochs=epochs, sample_granule=granule)
    base_cfg = CodecConfig(train=tspec, base_codec=base_codec)
    n_jobs = len(scenes) * len(ks)
    total_px = sum(h * w for stem, c, h, w in scenes for _ in ks)
    total_spx = sum(c * h * w for stem, c, h, w in scenes for _ in ks)
    log(f"[workload] {n_jobs} jobs, {total_px / 1e9:.3f} Gpx, "
        f"{total_spx / 1e9:.3f} Gsubpx")

    # --- phase 2: dataset encode, one resumable scene at a time ---------
    # Per-scene encode_dataset + immediate bin writes: at flagship scale
    # one scene's K points already fill the staging budget (chunks of
    # 2-6 experts of one image, codec._plan_group), and a killed run
    # resumes at the next scene.
    groups = scene_groups([s for s, _, _, _ in scenes])
    group_of = {scenes[i][0]: g for g, idx in groups.items() for i in idx}
    per_group = {g: {"staging": set(), "chunks": [], "seconds": 0.0, "jobs": 0}
                 for g in groups}
    bl = BuildLog()
    bl.__enter__()
    bins = []
    plans = {}  # stem -> the plan of its expert group, where it had one
    peaks = {}  # stem -> its encode's peak device GB, allocated and reserved
    t_enc = 0.0
    enc_px = enc_spx = 0
    for stem, c, h, w in scenes:
        scene_bins = []
        for K in ks:
            cfg = dataclasses.replace(base_cfg, K=K)
            run_dir = os.path.join(run_root, cfg.run_name(stem))
            scene_bins.append(
                (os.path.join(run_dir, f"{stem}.bin"), run_dir, stem, K)
            )
        if stem not in made and all(os.path.exists(b[0]) for b in scene_bins):
            log(f"[encode] {stem}: resume-skip (bins present)")
            bins += scene_bins
            continue
        sjobs = [
            (imgs[stem], dataclasses.replace(base_cfg, K=K)) for K in ks
        ]
        if cuda:  # each scene's peaks its own: the last scene's blocks go back
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        results = codec.encode_dataset(sjobs, bucket=True, device=device)
        dt = time.time() - t0
        if cuda:
            peaks[stem] = {"allocated_gb": torch.cuda.max_memory_allocated(device) / 1e9,
                           "reserved_gb": torch.cuda.max_memory_reserved(device) / 1e9}
        # the chunk plan the scene's group ran (a single rate point goes
        # the pipelined way, one fit a job)
        plan = results[0][1].plan
        chunks = [len(ch) for ch in plan.chunks] if plan else [1] * len(ks)
        if plan:
            plans[stem] = {"bucket": [plan.H, plan.W], "staging": plan.staging,
                           "chunks": plan.chunks, "budget": plan.budget}
        t_enc += dt
        enc_px += h * w * len(ks)
        enc_spx += c * h * w * len(ks)
        for (bin_path, run_dir, _, K), (stream, stats) in zip(
            scene_bins, results
        ):
            os.makedirs(run_dir, exist_ok=True)
            lg = RunLogger(run_dir, "encode.txt", to_stdout=False)
            write_encode_outputs(
                lg, bin_path, stem, stream, stats,
                time.time() - stats.elapsed,
            )
            lg.close()
        staging = sorted({st.tiles[0].staging for _, st in results})
        g = per_group[group_of[stem]]
        g["staging"].update(staging)
        g["chunks"].append(chunks)
        g["seconds"] += dt
        g["jobs"] += len(ks)
        log(f"[encode] {stem}: {dt:.1f}s = "
            f"{h * w * len(ks) / 1e6 / dt:.2f} Mpx/s "
            f"({dt / len(ks):.2f} s/job, staging {'/'.join(staging)}, "
            f"{len(chunks)} chunks of E={chunks}"
            + (f", peak {peaks[stem]['allocated_gb']:.2f} GB allocated, "
               f"{peaks[stem]['reserved_gb']:.2f} reserved)" if cuda else ")"))
        bins += scene_bins
    if t_enc:
        log(f"[encode] encoded-scene total {t_enc:.1f}s = "
            f"{enc_px / 1e6 / t_enc:.2f} Mpx/s aggregate "
            f"({enc_spx / 1e6 / t_enc:.2f} Msubpx/s)")
    for name, g in per_group.items():
        if g["jobs"]:
            log(f"[encode] group {name}: staging {'/'.join(sorted(g['staging']))}, "
                f"{sum(len(ch) for ch in g['chunks'])} chunks, "
                f"{g['seconds'] / g['jobs']:.2f} s/job")
    peak_enc = max((p["allocated_gb"] for p in peaks.values()), default=None)
    if cuda:
        if peaks:
            log(f"[encode] peak device memory {peak_enc:.2f} GB")
        torch.cuda.reset_peak_memory_stats(device)

    # --- phase 3: pipelined decode with MSB verification -----------------
    def stream_gen():
        for bin_path, _, _, _ in bins:
            with open(bin_path, "rb") as f:
                yield f.read()

    baseline_rows = {K: {} for K in ks}  # K -> stem -> (mse, psnr, bpsp, bits)
    n_lossless = 0
    t0 = time.time()
    t_verify = 0.0
    for (bin_path, run_dir, stem, K), (rec, dstats) in zip(
        bins, codec.decode_pipelined_iter(stream_gen(), device=device)
    ):
        tv = time.time()
        org = imgs[stem]
        ok = np.array_equal(rec >> K, org >> K)
        n_lossless += ok
        mse = float(np.mean(
            (org.astype(np.float32) - rec.astype(np.float32)) ** 2
        ))
        ps = float(10 * np.log10(PSNR_PEAK**2 / mse)) if mse > 0 else 999.0
        nb = os.path.getsize(bin_path)
        n_sub = org.size
        lg = RunLogger(run_dir, "decode.txt", to_stdout=False)
        lg.info(f"Binstream: {bin_path}")
        lg.info(f"Time elapsed: {dstats.elapsed}")
        lg.info(f"MSE: {mse}")
        lg.info(f"PSNR: {ps}")
        lg.info(f"Total size: {nb} bytes, bpsp={nb * 8 / n_sub}")
        lg.close()
        if not ok:
            log(f"[decode] !! {stem} K={K} NOT MSB-lossless")
        # Baseline anchor: drop-LSB + the run's lossless base coder
        # (base stream size from the decoded header: resume-safe)
        base_bits = 8 * (sum(dstats.header.base_bytes) + 2)
        base_rec = ((rec >> K) << K).astype(np.float32)
        bmse = float(np.mean((org.astype(np.float32) - base_rec) ** 2))
        bps = float(10 * np.log10(PSNR_PEAK**2 / bmse)) if bmse > 0 else 999.0
        baseline_rows[K][stem] = (bmse, bps, base_bits / n_sub, base_bits)
        t_verify += time.time() - tv
    t_dec = time.time() - t0
    log(f"[decode] {t_dec:.1f}s = {total_px / 1e6 / t_dec:.2f} Mpx/s "
        f"aggregate ({total_spx / 1e6 / t_dec:.2f} Msubpx/s, "
        f"{t_dec / n_jobs:.2f} s/job); inline verify+metrics "
        f"{t_verify:.1f}s of that")
    log(f"[decode] MSB-lossless {n_lossless}/{n_jobs}")
    codec_dec = t_dec - t_verify
    log(f"[decode] codec-only (minus inline verify) {codec_dec:.1f}s = "
        f"{total_px / 1e6 / codec_dec:.2f} Mpx/s")
    peak_dec = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None
    if cuda:
        log(f"[decode] peak device memory {peak_dec:.2f} GB")

    # --- library builds ---------------------------------------------------
    bl.__exit__()
    log("")
    log("```")
    log(bl.report())
    log("```")

    # --- phase 4/5: summarize + BD vs Baseline ---------------------------
    stems = [s for s, _, _, _ in scenes]

    def cfg_for_k(K):
        return dataclasses.replace(base_cfg, K=K)

    csv_path = summarize(run_root, stems, cfg_for_k, ks[0], ks[-1])
    log(f"[summarize] {csv_path}")

    anchor_csv = os.path.join(run_root, "Baseline_flagship.csv")
    metrics = ["MSE", "PSNR", "bpsp", "bits"]
    with open(anchor_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["K"] + [f"{s}_{m}" for s in stems for m in metrics])
        for K in ks:
            row = [f"K{K}"]
            for s in stems:
                bmse, bps, bpsp_, bits = baseline_rows[K][s]
                row += [bmse, bps, bpsp_, bits]
            w.writerow(row)
    log(f"[anchors] Baseline ({base_codec} base) -> {anchor_csv}")

    md = bd_table_markdown(
        {"Baseline": anchor_csv}, csv_path, len(stems), groups,
        k_points=len(ks),
    )
    log("")
    log(md)

    raw = os.path.join(wd, "FLAGSHIP_raw.md")
    with open(raw, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"raw report -> {raw}")
    bd = bd_report(anchor_csv, csv_path, len(stems), len(ks), groups=groups)
    return {
        "imgs": imgs, "bins": [(b[0], b[2], b[3]) for b in bins],
        "n_jobs": n_jobs, "n_lossless": int(n_lossless),
        "groups": {name: {"staging": sorted(g["staging"]), "chunks": g["chunks"],
                          "seconds": g["seconds"], "jobs": g["jobs"],
                          "seconds_per_job": g["seconds"] / g["jobs"] if g["jobs"] else None}
                   for name, g in per_group.items()},
        "plans": plans, "scene_peaks": peaks,
        "encode_s": t_enc, "encode_mpx_s": enc_px / 1e6 / t_enc if t_enc else None,
        "decode_s": t_dec, "decode_mpx_s": total_px / 1e6 / t_dec,
        "peak_encode_gb": peak_enc, "peak_decode_gb": peak_dec,
        "results_csv": csv_path, "baseline_csv": anchor_csv,
        "bd_rate": bd.group_rate, "bd_psnr": bd.group_psnr, "table": md, "raw": raw,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", required=True,
                   help="where the synthetic TIFFs (about 5.6 GB at the real shapes), "
                        "the streams and FLAGSHIP_raw.md go; an earlier run's files "
                        "there are resumed")
    p.add_argument("--k-min", type=int, default=1)
    p.add_argument("--k-max", type=int, default=6)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--granule", type=int, default=8)
    p.add_argument("--base-codec", default="lpc")
    p.add_argument("--scenes", type=int, default=len(SCENES),
                   help="use only the first N scenes (small smoke runs)")
    p.add_argument("--shrink", type=int, default=1,
                   help="divide every scene dimension by N (CPU smoke runs)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; the run stops when CUDA is "
                        "absent unless --device cpu is given)")
    args = p.parse_args(argv)

    from lbdrn_msic_tpu_torch.cli.common import device_from_args

    device = device_from_args(args)
    scenes = [
        (stem, c, h // args.shrink, w // args.shrink)
        for stem, c, h, w in SCENES[: args.scenes]
    ]
    run(scenes, list(range(args.k_min, args.k_max + 1)), args.epochs, args.workdir,
        device, args.granule, args.base_codec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
