"""Harness for external learned bit-depth-recovery anchors (BitMore / ABCD).

Mirrors the role of reference SOTA_BDR.py:35-251: those anchors live in
external repos with their own checkpoints; this harness

1. tiles each 16-bit multiband scene into 3-band PNG "divs" the external
   `test.py` scripts consume (`generate_divs`, after SOTA_BDR.py:35-58
   `gen_bgr_div`: div grid with last-tile remainder absorption, optional
   `<<3` scaling when the data is 13-bit-effective, band triples),
2. shells out to the external repo's test entry point (gated — absent in
   this runtime, injectable for tests),
3. reassembles div outputs, masks the untouched extra bands, computes PSNR
   per in_bits (`assemble_and_psnr`, after SOTA_BDR.py:62-117), and
4. writes the per-(image, in_bits) PSNR grid CSV in the reference's
   `test_{method}[_GF6].csv` shape.

The div/assembly/PSNR machinery is fully functional and tested with a
mock "external model"; only the actual subprocess call requires the
external checkout.
"""

from __future__ import annotations

import csv
import os
import subprocess
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def _div_bounds(n: int, parts: int) -> List[tuple[int, int]]:
    d = n // parts
    return [(d * i, d * (i + 1) if i != parts - 1 else n) for i in range(parts)]


def generate_divs(
    img: np.ndarray,
    out_dir: str,
    name: str,
    div_h: int = 8,
    div_w: int = 8,
    with_zeros: bool = True,
    extra_as_bgr: bool = True,
) -> List[str]:
    """Write {name}_Div{i}_{j}_{c}.png 3-band tiles; returns the paths.

    with_zeros=False applies the reference's `<<3` widening for
    13-bit-effective data (SOTA_BDR.py:41-43).
    """
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    hwc = img.transpose(1, 2, 0).copy()
    if not with_zeros:
        if not np.all(hwc <= 8191):
            raise ValueError("with_zeros=False expects <=13-bit samples")
        hwc <<= 3
    n_c = hwc.shape[2] // 3 if extra_as_bgr else 1
    paths = []
    for i, (h0, h1) in enumerate(_div_bounds(hwc.shape[0], div_h)):
        for j, (w0, w1) in enumerate(_div_bounds(hwc.shape[1], div_w)):
            for ci in range(n_c):
                p = os.path.join(out_dir, f"{name}_Div{i}_{j}_{ci}.png")
                cv2.imwrite(p, hwc[h0:h1, w0:w1, 3 * ci : 3 * (ci + 1)])
                paths.append(p)
    return paths


def assemble_and_psnr(
    img: np.ndarray,
    out_dir: str,
    name: str,
    in_bits: int,
    div_h: int = 8,
    div_w: int = 8,
    with_zeros: bool = True,
    extra_as_bgr: bool = True,
    peak: float = 10000.0,
) -> tuple[float, float]:
    """Reassemble {name}_Div{i}_{j}_{c}_output.png tiles; (bgr_psnr, psnr).

    Extra bands beyond the processed triples are masked to in_bits as the
    reference does (SOTA_BDR.py:86-91).
    """
    import cv2

    hwc = img.transpose(1, 2, 0)
    n_c = hwc.shape[2] // 3 if extra_as_bgr else 1
    recon = np.empty((hwc.shape[0], hwc.shape[1], n_c * 3), np.uint16)
    for i, (h0, h1) in enumerate(_div_bounds(hwc.shape[0], div_h)):
        for j, (w0, w1) in enumerate(_div_bounds(hwc.shape[1], div_w)):
            for ci in range(n_c):
                p = os.path.join(out_dir, f"{name}_Div{i}_{j}_{ci}_output.png")
                tile = cv2.imread(p, cv2.IMREAD_UNCHANGED)
                if tile is None:
                    raise FileNotFoundError(p)
                recon[h0:h1, w0:w1, 3 * ci : 3 * (ci + 1)] = tile
    if with_zeros:
        mask = int("1" * in_bits + "0" * (16 - in_bits), 2)
    else:
        mask = int("1" * (in_bits + 3) + "0" * (13 - in_bits), 2)
    recon = np.concatenate([recon, hwc[:, :, n_c * 3 :] & mask], axis=2)

    def _psnr(a, b):
        # guard the perfect-recon case as eval/metrics.py::psnr does
        # (peak**2 / 0 would emit a divide-by-zero RuntimeWarning)
        m = np.mean((a.astype(np.float64) - b) ** 2)
        if m == 0:
            return float("inf")
        return float(10 * np.log10(peak**2 / m))

    bgr = _psnr(recon[:, :, :3], hwc[:, :, :3])
    full = _psnr(recon, hwc)
    return bgr, full


def run_external_model(
    repo_dir: str, test_cmd: Sequence[str], cwd: Optional[str] = None
) -> None:
    """Shell out to an external anchor repo's test entry point
    (reference SOTA_BDR.py drives BitMore/ABCD `test.py` this way)."""
    if not os.path.isdir(repo_dir):
        raise RuntimeError(
            f"external anchor repo not found at {repo_dir}; "
            "clone it and pass its path to enable this anchor"
        )
    subprocess.run(list(test_cmd), check=True, cwd=cwd or repo_dir)


def external_repo_dir(env_var: str) -> Optional[str]:
    """Path of an external anchor checkout from `env_var` (e.g.
    BITMORE_REPO / ABCD_REPO), or None when absent — the gate the
    skip-marked real-path tests use."""
    d = os.environ.get(env_var)
    return d if d and os.path.isfile(os.path.join(d, "test.py")) else None


def bitmore_command(
    set_name: str, in_bits: int, hbd: int = 16, python: Optional[str] = None
) -> list:
    """The BitMore repo's test.py invocation, argument-for-argument as the
    reference builds it (reference SOTA_BDR.py:166-170)."""
    import sys as _sys

    return [
        python or _sys.executable, "test.py",
        "--set_names", set_name,
        "--type_8_or_16", "1",
        "--quant", str(in_bits), "--quant_end", str(hbd),
        "--dep", "16", "--save_result", "1",
    ]


def abcd_command(
    div_dir: str, save_path: str, in_bits: int, hbd: int = 16,
    model: str = "edsr", python: Optional[str] = None,
) -> list:
    """The ABCD repo's test.py invocation as the reference builds it
    (reference SOTA_BDR.py:124-137), including the per-model checkpoint
    flags."""
    import sys as _sys

    cmd = [
        python or _sys.executable, "test.py",
        "--config", "configs/test_ABCD/abcd_test-16bits.yaml",
        "--testset_root", div_dir,
        "--save_path", save_path,
        "--LBD", str(in_bits), "--HBD", str(hbd),
        "--gpu", "0", "--save", "1",
    ]
    if model == "edsr":
        cmd += ["--model", "save/edsr-abcd.pth"]
    elif model == "swin":
        cmd += ["--model", "save/swin_abcd.pth", "--window", "8"]
    else:
        raise ValueError(f"unknown ABCD model {model!r}")
    return cmd


def psnr_grid_to_csv(
    results: Dict[str, Dict[int, float]], out_csv: str, in_bits_range: Sequence[int]
) -> str:
    """Write the reference's test_{method}.csv shape: rows = in_bits
    (descending), one PSNR column per image."""
    names = list(results)
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["in_bits"] + names)
        for b in sorted(in_bits_range, reverse=True):
            w.writerow([b] + [results[n].get(b) for n in names])
    return out_csv


def evaluate_bdr_anchor(
    images: Dict[str, np.ndarray],
    in_bits_range: Sequence[int],
    out_csv: str,
    run_model: Callable[[str, int], None],
    work_dir: str,
    with_zeros: bool = True,
    extra_as_bgr: bool = True,
) -> str:
    """Full loop: divs -> external model (via `run_model(div_dir, in_bits)`
    callback) -> reassembly -> PSNR grid CSV."""
    results: Dict[str, Dict[int, float]] = {n: {} for n in images}
    for in_bits in in_bits_range:
        div_dir = os.path.join(work_dir, f"div_{in_bits}")
        for name, img in images.items():
            generate_divs(img, div_dir, name, with_zeros=with_zeros,
                          extra_as_bgr=extra_as_bgr)
        run_model(div_dir, in_bits)
        for name, img in images.items():
            _, p = assemble_and_psnr(img, div_dir, name, in_bits,
                                     with_zeros=with_zeros,
                                     extra_as_bgr=extra_as_bgr)
            results[name][in_bits] = p
    return psnr_grid_to_csv(results, out_csv, in_bits_range)
