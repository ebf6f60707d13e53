"""Run logging: per-run encode.txt / decode.txt in the reference's format.

The reference's logs double as its metric store and resume markers — the
results scraper regexes `MSE:`, `PSNR:`, `bpsp=`, `Time elapsed:` lines out
of decode.txt/encode.txt (reference results_summary.py:7-53, logger.py:9-25),
and completed runs are detected by grepping for "Time elapsed" / "bpsp"
(reference encode.py:216-224, decode.py:168-176).  This module emits the
same scrape-compatible lines (so the reference's own tooling would work on
our runs) plus a structured JSONL sidecar for programmatic use.
"""

from __future__ import annotations

import json
import logging
import os
import sys


class RunLogger:
    def __init__(self, out_dir: str, file_name: str, to_stdout: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, file_name)
        self.jsonl_path = self.path + ".jsonl"
        self._log = logging.getLogger(f"lbdrn.{self.path}")
        self._log.setLevel(logging.INFO)
        self._log.propagate = False
        for h in list(self._log.handlers):
            self._log.removeHandler(h)
        fmt = logging.Formatter("[%(asctime)s] %(message)s")
        fh = logging.FileHandler(self.path, mode="w")
        fh.setFormatter(fmt)
        self._log.addHandler(fh)
        if to_stdout:
            sh = logging.StreamHandler(sys.stdout)
            sh.setFormatter(fmt)
            self._log.addHandler(sh)
        self._jsonl = open(self.jsonl_path, "w")

    def info(self, msg: str, **fields):
        self._log.info(msg)
        if fields:
            self.event(**fields)

    def event(self, **fields):
        self._jsonl.write(json.dumps(fields) + "\n")
        self._jsonl.flush()

    def close(self):
        for h in list(self._log.handlers):
            h.close()
            self._log.removeHandler(h)
        self._jsonl.close()


def run_is_complete(out_dir: str, file_name: str, marker: str) -> bool:
    """Resume marker check (reference encode.py:216-224 / decode.py:168-176)."""
    path = os.path.join(out_dir, file_name)
    if not os.path.exists(path):
        return False
    with open(path) as f:
        return marker in f.read()


def scrape_log(path: str) -> dict:
    """Extract metrics from a run log (regexes per reference
    results_summary.py:9-13)."""
    import re

    patterns = {
        "mse": r"MSE: ([\d.eE+-]+)",
        "psnr": r"PSNR: ([\d.eE+-]+|inf)",
        "bpsp": r"bpsp=([\d.eE+-]+)",
        "bytes": r"Total size: (\d+) bytes",
        "time": r"Time elapsed: ([\d.eE+-]+)",
    }
    out: dict = {}
    if not os.path.exists(path):
        return out
    text = open(path).read()
    for key, pat in patterns.items():
        m = re.findall(pat, text)
        if m:
            out[key] = float(m[-1]) if key != "bytes" else int(m[-1])
    return out
