"""BD reports and RD plots over results CSVs.

Consumes the canonical results CSV schema (rows K1..K11, columns
`{image}_{MSE,PSNR,bpsp,bits}`) written by cli/summarize.py and
eval/anchors.py — which is the same schema the reference ships in
SOTA_results/ — so reference-produced CSVs (e.g. the published anchors)
can be compared against runs of this framework directly.  Mirrors the
reporting layer of reference BD_metrics.py:111-1349.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from lbdrn_msic_tpu_torch.eval.metrics import bd_psnr, bd_rate


def read_results_csv(
    path: str, n_images: int, k_points: int = 6, last: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(psnr, bits, bpsp), each (n_images, k_points).

    `last=False` takes the FIRST k_points rate rows (reference
    BD_metrics.py:73-89 read_csv), `last=True` the LAST k_points
    (read_csv_lbr, :92-108 — the low-bitrate regime).
    """
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f)][1:]
    rows = rows[-k_points:] if last else rows[:k_points]
    if len(rows) < k_points:
        raise ValueError(f"{path}: wanted {k_points} rate rows, found {len(rows)}")
    psnr = np.zeros((n_images, k_points))
    bits = np.zeros((n_images, k_points))
    bpsp = np.zeros((n_images, k_points))
    for r, row in enumerate(rows):
        for i in range(n_images):
            psnr[i, r] = float(row[4 * i + 2])
            bpsp[i, r] = float(row[4 * i + 3])
            bits[i, r] = float(row[4 * i + 4])
    return psnr, bits, bpsp


@dataclasses.dataclass
class BDResult:
    per_image_rate: List[float]
    per_image_psnr: List[float]
    group_rate: Dict[str, float]
    group_psnr: Dict[str, float]


def bd_report(
    anchor_csv: str,
    test_csv: str,
    n_images: int,
    k_points: int = 6,
    groups: Optional[Dict[str, Sequence[int]]] = None,
    piecewise: bool = False,
    last: bool = False,
) -> BDResult:
    """Per-image and per-group BD-Rate/BD-PSNR of test vs anchor.

    `groups` maps a label to image indices (e.g. the reference's
    GF-2=0..4, WFI=5..8, PMS=9..12 split); means are taken over the
     3-decimal-rounded per-image numbers, as the reference does
    (BD_metrics.py:409-417).
    """
    a_psnr, a_bits, _ = read_results_csv(anchor_csv, n_images, k_points, last)
    t_psnr, t_bits, _ = read_results_csv(test_csv, n_images, k_points, last)
    # a lossless rate point reports PSNR = inf (e.g. a lossy anchor that hit
    # reversibility); clamp so the Bjontegaard polyfit stays finite
    a_psnr = np.where(np.isfinite(a_psnr), a_psnr, 99.999)
    t_psnr = np.where(np.isfinite(t_psnr), t_psnr, 99.999)
    rates, psnrs = [], []
    for i in range(n_images):
        rates.append(round(bd_rate(a_bits[i], a_psnr[i], t_bits[i], t_psnr[i],
                                   piecewise=piecewise), 3))
        psnrs.append(round(bd_psnr(a_bits[i], a_psnr[i], t_bits[i], t_psnr[i],
                                   piecewise=piecewise), 3))
    groups = groups or {"all": list(range(n_images))}
    g_rate = {g: float(np.mean([rates[i] for i in idx])) for g, idx in groups.items()}
    g_psnr = {g: float(np.mean([psnrs[i] for i in idx])) for g, idx in groups.items()}
    return BDResult(rates, psnrs, g_rate, g_psnr)


def _render_table(header: Sequence[str], rows: Sequence[Sequence[str]],
                  fmt: str) -> str:
    """Render a table as markdown or a LaTeX tabular (the reference's paper
    emitters print LaTeX rows, BD_metrics.py:400-520)."""
    if fmt == "latex":
        def esc(s: str) -> str:
            return s.replace("%", "\\%").replace("<=", "$\\le$")

        lines = [
            "\\begin{tabular}{l" + "r" * (len(header) - 1) + "}",
            " & ".join(esc(h) for h in header) + " \\\\ \\hline",
        ]
        lines += [" & ".join(esc(c) for c in r) + " \\\\" for r in rows]
        lines.append("\\end{tabular}")
        return "\n".join(lines)
    if fmt != "markdown":
        raise ValueError(f"unknown table format {fmt!r}")
    lines = ["| " + " | ".join(header) + " |", "|" + "---|" * len(header)]
    lines += ["| " + " | ".join(r) + " |" for r in rows]
    return "\n".join(lines)


def bd_table_markdown(
    anchors: Dict[str, str], test_csv: str, n_images: int,
    groups: Dict[str, Sequence[int]], k_points: int = 6, last: bool = False,
    fmt: str = "markdown",
) -> str:
    """BD table: one row per anchor, group means (reference
    BD_metrics.py:400-520; fmt='latex' reproduces its tabular output)."""
    header = ["Against"] + [
        h for g in groups for h in (f"{g} BD-Rate %", f"{g} BD-PSNR dB")
    ]
    rows = []
    for name, csv_path in anchors.items():
        r = bd_report(csv_path, test_csv, n_images, k_points, groups=groups, last=last)
        cells = []
        for g in groups:
            cells.append(f"{r.group_rate[g]:.3f}")
            cells.append(f"{r.group_psnr[g]:.3f}")
        rows.append([name] + cells)
    return _render_table(header, rows, fmt)


def ablation_table_markdown(
    variants: Dict[str, str], anchor_csv: str, n_images: int,
    groups: Dict[str, Sequence[int]], k_points: int = 6, last: bool = False,
    fmt: str = "markdown",
) -> str:
    """Ablation table: BD-Rate/BD-PSNR of each config variant vs a common
    anchor (the role of reference BD_metrics.py feature_set() /
    network_hyperparameter() / training_hyperparameter() / split_ratio
    reports, generalized: variants come from CSVs instead of hard-coded
    lists)."""
    header = ["Variant"] + [
        h for g in groups for h in (f"{g} BD-Rate %", f"{g} BD-PSNR dB")
    ]
    rows = []
    for name, csv_path in variants.items():
        r = bd_report(anchor_csv, csv_path, n_images, k_points, groups=groups, last=last)
        cells = []
        for g in groups:
            cells.append(f"{r.group_rate[g]:.3f}")
            cells.append(f"{r.group_psnr[g]:.3f}")
        rows.append([name] + cells)
    return _render_table(header, rows, fmt)


def error_stats_table(
    org: np.ndarray, recons: Dict[str, np.ndarray], thresholds: Sequence[int] = (0, 1, 2, 4, 8),
    fmt: str = "markdown",
) -> str:
    """|error| distribution per method (the role of the reference's
    error_reconstruction/error_stats LaTeX emitters, SOTA.py:245-321):
    max error and the fraction of subpixels with |error| <= t per
    threshold; fmt='latex' emits the reference-style tabular."""
    header = ["Method", "max"] + [f"<= {t} (%)" for t in thresholds]
    rows = []
    for name, rec in recons.items():
        e = np.abs(rec.astype(np.int64) - org.astype(np.int64))
        cells = [str(int(e.max()))]
        for t in thresholds:
            cells.append(f"{100.0 * np.mean(e <= t):.3f}")
        rows.append([name] + cells)
    return _render_table(header, rows, fmt)


def rd_plot(
    curves: Dict[str, str], image_index: int, out_png: str,
    n_images: int, k_points: int = 6, use_bpsp: bool = True, last: bool = False,
) -> str:
    """RD curves (PSNR vs bpsp) for one image across methods
    (reference BD_metrics.py RD-figure sections)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4.5))
    for label, path in curves.items():
        psnr, bits, bpsp = read_results_csv(path, n_images, k_points, last)
        x = bpsp[image_index] if use_bpsp else bits[image_index]
        order = np.argsort(x)
        ax.plot(x[order], psnr[image_index][order], marker="o", label=label)
    ax.set_xlabel("bpsp" if use_bpsp else "bits")
    ax.set_ylabel("PSNR (dB)")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png
