"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

`--trace 0` measures the cell's end-to-end metrics, `--trace 1` its
per-layer metrics under torch.profiler.  Prints the run's notes and, as
its last lines on standard error, every number the judge compared beside
its limit; then, as the last line of standard output, one JSON object:
correct, attempted, failed, metrics, device, (breakdown,) checks.  Exits
non-zero without a result where CUDA or the cell's cards are missing, and
where `jax`, `jaxlib`, `flax` or the JAX package `lbdrn_msic_tpu` is
loaded once the window has closed.  See benchmark/README.md.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "lbdrn_msic_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `lbdrn_msic_tpu_torch` is the port."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def fixed_caches(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the port
    builds its libraries under lbdrn_msic_tpu_torch/_build/ itself)."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def host_threads(workload: str, root: str = ROOT):
    """The cell's mix's `host_threads` (None: the process's defaults), read
    before torch loads; where set, the process's OpenMP and BLAS pools are
    capped at it, so that the thread issuing the card's work keeps a core."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if workload not in cells:
        return None  # the harness names the unknown cell
    with open(os.path.join(BENCH, "traffic", cells[workload]["traffic"] + ".json")) as f:
        n = json.load(f).get("host_threads")
    if n is not None:
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
            os.environ[var] = str(n)
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    fixed_caches(ROOT)
    threads = host_threads(args.workload)
    sys.path[:0] = [BENCH, ROOT]
    import torch

    if threads is not None:
        torch.set_num_threads(threads)

    from harness import resolve, run_cell

    chips = resolve(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the benchmark's process: {bad}", file=sys.stderr)
        return 3
    res = out["result"]
    for line in out["notes"]:
        print(line, file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
