"""Readings that set the judge's limits, on the card: sound runs of a cell
on many seeds, its control and its planted faults on a few, all in one
process (short windows at the cell's own sizes and load).

    python3 benchmark/calibrate.py --workload <name> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...] --out <file.jsonl>

Each run appends one JSON line: mode, seed, correct and every number the
judge compared.  Modes: "sound"; "control" (an encode's bf16 products, a
decode's reference decode in bf16 in the program's place);
"control_decode" (an encode's decodes replaced alike); the faults
"answer_altered" (the decode's answer altered where it is produced) and
the step tap's (harness.TAP_FAULTS): "unchanged" (a training step
returns its state unchanged), "half_batch" (half of each batch left out,
the mean over the rest, in the batch the program builds; in a decode,
half of each decode batch's rows), "half_batch_step" (the same inside
the step), "repeat_rows" (rows of a batch repeated), "eval_part" (the
eval over half of the scene), "eval_skip" (every other eval skipped).
The benchmark's own runs never run these.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seconds", type=float, default=None,
                   help="the window of the control and fault runs (default --seconds)")
    p.add_argument("--modes", nargs="*", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [BENCH, ROOT]
    from run import fixed_caches, host_threads

    fixed_caches(ROOT)
    threads = host_threads(args.workload)
    import torch

    from harness import resolve, run_cell

    if threads is not None:
        torch.set_num_threads(threads)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    decode = resolve(args.workload)["traffic"]["entry"] == "decode"
    modes = args.modes or (["control", "half_batch", "answer_altered"] if decode else
                           ["control", "control_decode", "answer_altered", "unchanged",
                            "half_batch", "half_batch_step", "repeat_rows", "eval_part",
                            "eval_skip"])
    runs = [("sound", s) for s in args.seeds] + [(m, s) for s in args.control_seeds
                                                 for m in modes]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        for mode, seed in runs:
            t0 = time.time()
            secs = args.seconds if mode == "sound" else (args.fault_seconds or args.seconds)
            out = run_cell(args.workload, seed, secs, False, device,
                           mode=None if mode == "sound" else mode)
            res = out["result"]
            line = {"workload": args.workload, "mode": mode, "seed": seed,
                    "correct": res["correct"], "seconds": time.time() - t0,
                    "window_s": out["run"].window_s, "points": res["attempted"],
                    "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                    "numbers": {k: v["value"] for k, v in res["checks"].items()}}
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
