"""One run of one benchmark cell: set-up, the measured window, the traced
window's reading, and the judge.

Everything a cell is made of is found by name: `BENCHMARK.json` names the
cell's configuration (`benchmark/configs/<config>.json`, via its `file`)
and traffic mix (`benchmark/traffic/<traffic>.json`); every metric is
read by `benchmark/metrics/<metric>.py`; the judge's limits are
`benchmark/limits/<workload>.json`.  See benchmark/README.md.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import os
import sys
import time
from typing import Optional

import numpy as np

from reference import judge
from reference.frozen import busy_union, device_info, peaks
from traffic import Job, Mix, Point, seeds_of

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
STEP_NAMES = ("fused_train_step", "reference_train_step", "fused_expert_step",
              "_exact_expert_step")
MULTI_NAMES = ("fused_multi_step", "fused_expert_multi_step")
EVAL_NAME = "blocks_mse"
LABELS = ("job:", "phase:", "traced_window")  # the harness's profiler ranges
# the planted faults the step tap makes (benchmark/calibrate.py, the tests)
TAP_FAULTS = ("unchanged", "half_batch", "half_batch_step", "repeat_rows", "eval_part",
              "eval_skip")


# ------------------------------------------------------------------ lookup
def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, root: str = ROOT) -> dict:
    """The cell `workload` and everything it names, read from its files."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"] in reported else [])]
    return {
        "spec": spec, "cell": cell, "config": load_json(os.path.join(root, cfg_entry["file"])),
        "traffic": load_json(os.path.join(BENCH_DIR, "traffic", cell["traffic"] + ".json")),
        "end_to_end": e2e, "per_layer": layer,
        "limits": load_json(os.path.join(BENCH_DIR, "limits", workload + ".json")),
    }


def reader(name: str):
    """The module `benchmark/metrics/<name>.py`; its `read(run)` gives the
    metric's value, or None where the run holds nothing to read."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ the step tap
class StepTap:
    """Wraps the training loop's step functions and its eval (`train.loop`'s
    module names, looked up at each call), passing every call through.  It
    counts each job's steps (a multi-step call counts its k steps), keeps
    the first `capture` steps of a job and those whose Adam step is above
    `late_from` (inputs, state before and after, loss) for the judge's
    replay, and keeps every eval's MSE with the epoch it closed.  For the
    control and the planted faults it can switch on the program's bf16
    products, return the state unchanged, mask half of each batch (in the
    batch the program builds: "half_batch"; inside the step, after the
    batch is kept: "half_batch_step"), repeat each even row of a batch
    in its odd row ("repeat_rows"), or compute the eval over half of
    the scene ("eval_part") or skip every other eval ("eval_skip").
    `fused` sends the exact autograd steps of a CPU run to the fused
    steps' plain versions, the card's path."""

    def __init__(self):
        from lbdrn_msic_tpu_torch.train import loop

        self.loop = loop
        self.orig = {n: getattr(loop, n) for n in STEP_NAMES + MULTI_NAMES + (EVAL_NAME,)}
        self.capture, self.records, self.job = 0, [], None
        self.late_from, self.calls = None, {}
        self.evals = []  # (job, epoch, the 0-d MSE tensor the program reads)
        self.mm_dtype = self.fault = None
        self.fused = False
        self._depth = 0
        for n in STEP_NAMES:
            setattr(loop, n, self._wrap(n))
        for n in MULTI_NAMES:
            setattr(loop, n, self._wrap_multi(n))
        setattr(loop, EVAL_NAME, self._wrap_eval())

    def remove(self):
        for n, f in self.orig.items():
            setattr(self.loop, n, f)

    def _count(self, k: int):
        self.calls[self.job] = self.calls.get(self.job, 0) + k

    def _wrap(self, name: str):
        expert = "expert" in name
        real = self.orig[name]

        def step(params, m, v, x, y, mask, lr, t, mspec, dim_out, *args, **kw):
            if self._depth:  # the exact expert step's own per-expert calls
                return real(params, m, v, x, y, mask, lr, t, mspec, dim_out, *args, **kw)
            fn = real
            if self.fused and name in ("reference_train_step", "_exact_expert_step"):
                fn = self.orig["fused_expert_step" if expert else "fused_train_step"]
                kw = {"loss_out": kw.get("loss_out", args[0] if args else None)}
            if self.mm_dtype is not None:
                kw["mm_dtype"] = self.mm_dtype
            if self.fault == "half_batch":  # the batch as the program hands it on
                mask = mask.clone()
                mask[..., 1::2] = 0
            if self.fault == "repeat_rows":  # every odd row a copy of the row before
                x, y = x.clone(), y.clone()
                x[..., 1::2, :] = x[..., 0::2, :]
                y[..., 1::2, :] = y[..., 0::2, :]
            rec = None
            self._count(1)
            late = self.late_from is not None and t > self.late_from
            if self.capture > 0 or late:
                self.capture -= not late
                rec = {"job": self.job, "expert": expert, "late": late,
                       "pre": [p.clone() for p in params.leaves()],
                       "x": x.clone(), "y": y.clone(), "mask": mask.clone(),
                       "lr": float(lr), "t": int(t)}
            self._depth += 1
            try:
                if self.fault == "unchanged":
                    out = (params, m, v, kw.get("loss_out"))
                else:
                    if self.fault == "half_batch_step":
                        mask = mask.clone()
                        mask[..., 1::2] = 0
                    out = fn(params, m, v, x, y, mask, lr, t, mspec, dim_out, **kw)
            finally:
                self._depth -= 1
            if rec is not None:
                rec["post"] = [p.clone() for p in params.leaves()]
                rec["m"] = [a.clone() for a in m.leaves()]
                loss = out[3]
                rec["loss"] = (loss.detach().clone() if loss is not None
                               else x.new_zeros(x.shape[0] if expert else ()))
                self.records.append(rec)
            return out

        return step

    def _wrap_multi(self, name: str):
        """k steps a call (K3, K4): counted, never kept; a kept job that
        trains this way leaves the judge without its steps."""
        real = self.orig[name]

        def multi(params, m, v, X, *args, **kw):
            self._count(int(X.shape[0]))
            if self.mm_dtype is not None:
                kw["mm_dtype"] = self.mm_dtype
            if self.fault == "unchanged":
                return params, m, v, kw.get("loss_out")
            return real(params, m, v, X, *args, **kw)

        return multi

    def _wrap_eval(self):
        real = self.orig[EVAL_NAME]

        def blocks_mse(params, x_rows, y_rows, mspec, H, W, C, block_rows, *args, **kw):
            epoch = sys._getframe(1).f_locals.get("epoch")  # the fit's epoch it closes
            mine = [e for e in self.evals if e[0] == self.job]
            if self.fault == "eval_skip" and len(mine) % 2 == 1:
                import torch
                self.evals.append((self.job, -1, None))  # skipped: the program never sees it
                return torch.tensor(float("inf"))
            if self.fault == "eval_part" and kw.get("hw") is None:
                kw["hw"] = (H // 2, W)  # the top half, over the whole scene's count
                out = real(params, x_rows, y_rows, mspec, H, W, C, block_rows, *args, **kw) * 0.5
            else:
                out = real(params, x_rows, y_rows, mspec, H, W, C, block_rows, *args, **kw)
            self.evals.append((self.job, epoch, out))
            return out

        return blocks_mse

    def eval_series(self) -> list:
        """(job, epoch, MSE) of every eval the program read, as floats; a
        skipped one's epoch is -1."""
        return [(j, e, None if t is None else float(t)) for j, e, t in self.evals]


@contextlib.contextmanager
def patched(obj, name: str, fn):
    old = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, old)


def altered_answers(codec):
    """Fault: the decode's answer altered where it is produced (the lowest
    bit of the first band flipped)."""
    real = codec._finalize_decode

    def finalize(header, pending, pt):
        img = real(header, pending, pt)
        img[0] ^= 1
        return img

    return patched(codec, "_finalize_decode", finalize)


def half_decode_rows(reconstruct):
    """Fault: half of each decode batch's rows left out (their prediction
    zero)."""
    real = reconstruct.forward

    def forward(params, x, spec, *a, **kw):
        out = real(params, x, spec, *a, **kw)
        out[1::2] = 0
        return out

    return patched(reconstruct, "forward", forward)


# ------------------------------------------------------------------ tracing
@dataclasses.dataclass
class Trace:
    kernels: list  # (name, start_s, end_s), device operations
    window_s: float
    busy_s: float
    gaps: list  # (label, seconds): idle time by what the host was in
    points: int  # the traced jobs' points (or streams)


class Tracer:
    """torch.profiler over the traced jobs; host labels come from the
    harness's job spans and the program's own phases (its PhaseTimer),
    each opened as a profiler range while tracing."""

    def __init__(self, device):
        self.on = device.type == "cuda"
        self.prof = None

    def warm(self):
        """Profiler start-up (CUPTI) belongs to set-up."""
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from lbdrn_msic_tpu_torch.utils import profiling

        if not self.on:
            return
        self._phase = profiling.PhaseTimer.phase
        real = self._phase

        @contextlib.contextmanager
        def phase(timer, name):
            with torch.profiler.record_function("phase:" + name), real(timer, name):
                yield

        profiling.PhaseTimer.phase = phase
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self._window = torch.profiler.record_function("traced_window")
        self._window.__enter__()

    def job(self, label: str):
        if self.prof is None:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function("job:" + label)

    def stop(self, points: int) -> Optional[Trace]:
        if self.prof is None:
            return None
        import torch

        from lbdrn_msic_tpu_torch.utils import profiling

        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.prof.stop()
        profiling.PhaseTimer.phase = self._phase
        dev, spans, win = [], [], None
        for name, dtype, a, b in raw_events(self.prof):
            labelled = name.startswith(LABELS)
            if dtype == torch.autograd.DeviceType.CUDA:
                if not labelled:  # the labels' own device-side annotations are no work
                    dev.append((name, a, b))
            elif name == "traced_window":
                win = (a, b)
            elif labelled:
                spans.append((name, a, b))
        self.prof = None
        if win is None:
            win = (min(a for _, a, _ in dev), max(b for _, _, b in dev)) if dev else (0, 0)
        dev = [(n, max(a, win[0]), min(b, win[1])) for n, a, b in dev if b > win[0] and a < win[1]]
        busy = busy_union([(a, b) for _, a, b in dev])
        return Trace(dev, win[1] - win[0], busy, idle_gaps(dev, win, spans), points)


def raw_events(prof):
    """(name, device type, start s, end s) of every profiler event, read
    from the raw Kineto results: building the profiler's own event tree
    takes minutes for a traced job of ~10^5 kernels.  Memory records are
    no operations."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    for ev in res.events():
        name = ev.name()
        if name == "[memory]":
            continue
        a = (ev.start_ns() - t0) / 1e9
        yield name, ev.device_type(), a, a + ev.duration_ns() / 1e9


def idle_gaps(dev: list, win: tuple, spans: list) -> list:
    """Idle intervals of the device inside the window, each labelled by the
    innermost host span (a program phase, else a job, else "host") that
    holds its midpoint; seconds summed by label, longest first."""
    merged = []
    for _, a, b in sorted(dev, key=lambda e: e[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [win[0]] + [x for ab in merged for x in ab] + [win[1]]
    by = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [s for s in spans if s[1] <= mid <= s[2]]
        phases = [s for s in inner if s[0].startswith("phase:")]
        pick = min(phases or inner, key=lambda s: s[2] - s[1], default=None)
        label = pick[0].split(":", 1)[1] if pick and pick[0].startswith("phase:") else (
            "job (outside the program's phases)" if pick else "between jobs")
        by[label] = by.get(label, 0.0) + (b - a)
    return sorted(by.items(), key=lambda kv: -kv[1])


# ------------------------------------------------------------------ the run
@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    workload: str
    cell: dict
    config: dict
    traffic: dict
    device_name: str
    jobs: list  # the window's jobs
    window_s: float
    setup_s: float
    peak_window_bytes: Optional[int]
    trace: Optional[Trace]
    quality: dict  # psnr_db, bpsp means over the window's points

    def step_cost_dims(self) -> list:
        c = self.config
        return [c["bands"] * (2 * c["D"] + 1) ** 2] + [c["base_channel"]] * c["num_layers"] \
            + [c["bands"]]

    def peaks(self) -> dict:
        return peaks(self.device_name)

    def n_points(self) -> int:
        return sum(len(j.points) for j in self.jobs)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: Optional[float] = None, overrides: Optional[dict] = None,
             mode: Optional[str] = None) -> dict:
    """One run of `workload`.  `overrides` replace configuration and traffic
    keys (the CPU tests' small sizes); `mode` is None for a benchmark run,
    or for `calibrate.py` and the tests the control ("control": the
    program's bf16 products in an encode, the reference decode in bf16 in
    the program's place in a decode; "control_decode": the latter in an
    encode) or a planted fault ("answer_altered", or one of TAP_FAULTS).
    Returns {"result": the result line's dict, "checks": the judge's
    numbers and limits, "run": the Run, "notes": lines for the log}."""
    import torch

    t_start = time.time() if t_start is None else t_start
    r = resolve(workload)
    cfg, traffic = dict(r["config"]), dict(r["traffic"])
    for k, v in (overrides or {}).items():
        (cfg if k in cfg else traffic)[k] = v
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from lbdrn_msic_tpu_torch import codec
    from lbdrn_msic_tpu_torch.decode import reconstruct
    from lbdrn_msic_tpu_torch.ops import fused_step

    tap = StepTap()
    tap.fused = not cuda
    if mode == "control" and traffic["entry"] != "decode":
        tap.mm_dtype = "bfloat16"  # the program's own lower-precision path
    try:
        mix = Mix(traffic, cfg, seed, device)
        marks = [("imports", time.time())]
        mix.setup()
        marks.append(("scenes and the mix's set-up", time.time()))
        tracer = Tracer(device)
        if trace:
            tracer.warm()
        warm(mix)
        marks.append(("warm job", time.time()))
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        faults = contextlib.ExitStack()
        if mode in TAP_FAULTS:
            tap.fault = mode
            if traffic["entry"] == "decode" and mode == "half_batch":
                faults.enter_context(half_decode_rows(reconstruct))
        if mode == "answer_altered":
            faults.enter_context(altered_answers(codec))
        launches0 = (fused_step.fused_train_step.launches,
                     fused_step.fused_expert_step.launches)
        with faults:
            t_open = time.time()
            setup_s = t_open - t_start
            if traffic["entry"] == "decode":
                jobs, t_close, tr = decode_window(mix, seconds, tracer if trace else None, seed)
            else:
                jobs, t_close, tr = encode_window(mix, tap, seconds,
                                                  tracer if trace else None, seed)
            window_s = t_close - t_open
            launches = (fused_step.fused_train_step.launches - launches0[0],
                        fused_step.fused_expert_step.launches - launches0[1])
            peak_window = torch.cuda.max_memory_allocated() if cuda else None
            memory_peak = max(setup_peak, peak_window) if cuda else 0
            tap.fault = None
            tap.mm_dtype = None
            outputs = decode_outputs(mix, jobs, seed, traffic)
            marks.append(("the program's decodes after the window", time.time()))
        control = mode == "control_decode" or (mode == "control" and mix.entry == "decode")
        checks = judge.judge(mix, jobs, outputs, tap.records, tap.eval_series(), r["limits"],
                             device, control)
        marks.append(("the judge", time.time()))
    finally:
        tap.remove()

    quality = outputs["quality"]
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    run = Run(workload, r["cell"], cfg, traffic, name, jobs, window_s, setup_s, peak_window,
              tr, quality)
    metrics = {}
    wanted = r["per_layer"] if trace else r["end_to_end"]
    for m in wanted:
        val = reader(m["name"]).read(run)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": int(memory_peak)}
    if cuda:
        dev["power_limit"] = device_info(0)["power_limit"]
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    result = {"correct": checks["correct"], "attempted": outputs["attempted"],
              "failed": checks["failed"], "metrics": metrics, "device": dev}
    if trace and tr is not None:
        result["breakdown"] = breakdown(tr)
    result["checks"] = checks["numbers"]
    notes = [f"[bench] {workload} seed {seed}: setup_s {setup_s:.3f}, window_s {window_s:.3f}, "
             f"jobs {len(jobs)}, points {outputs['attempted']}; {name}, power limit "
             f"{dev.get('power_limit')}; K1 launches {launches[0]}, K2 {launches[1]} "
             f"(window and any job that ended past it)"]
    prev, spent = t_start, []
    for what, t in marks:
        if what == "the program's decodes after the window":
            prev = t_close
        spent.append(f"{what} {t - prev:.3f}s")
        prev = t
    notes.append("[bench] seconds: " + ", ".join(spent))
    notes += [f"[bench] not compared: {k} {v!r}" for k, v in checks["info"].items()]
    notes += [f"[bench] job 0: {line}" for line in job_notes(jobs[0])]
    return {"result": result, "checks": checks, "run": run, "notes": notes}


def job_notes(job: Job) -> list:
    """The entry's staging, staged bytes and chunk plan of a job."""
    out = []
    for p in job.points[:1]:
        tiles = getattr(p.stats, "tiles", None) or []
        if tiles:
            out.append(f"staging {tiles[0].staging}, staged_bytes {tiles[0].staged_bytes}")
        plan = getattr(p.stats, "plan", None)
        if plan is not None:
            out.append(f"plan staging {plan.staging}, chunks {plan.chunks}, "
                       f"per-expert bytes {plan.per_expert}")
    if job.phases:
        out.append("phases " + ", ".join(f"{k} {v:.4f}s" for k, v in sorted(job.phases.items())))
    return out


def warm(mix: Mix):
    """One job at the cell's shapes before the window: every kernel,
    allocation and thread pool of the window's path warm.  Encode mixes at
    two epochs (one epoch would skip the per-epoch eval), a decode mix over
    its streams once."""
    if mix.entry == "decode":
        from lbdrn_msic_tpu_torch.codec import decode_pipelined_iter
        for _ in decode_pipelined_iter([p.stream for p in mix.streams],
                                       ahead=int(mix.t["ahead"]), device=mix.device):
            pass
    else:
        mix.run_encode(0, epochs=2)


def encode_window(mix: Mix, tap: StepTap, seconds: float, tracer, seed: int):
    """Closed loop, one client: jobs back to back.  The window opens at the
    first job's start and closes at the end of the last job that ends
    within `seconds`; a job is not started where the previous job's length
    would carry it past the window.  A traced window closes after its
    `trace_jobs` jobs.  The first and last steps of the jobs the seed picks
    are kept for the judge's replay."""
    capture = set(int(i) for i in np.random.default_rng(seeds_of(seed, 1, 3)).choice(
        np.arange(1, 3), size=1)) | {0}
    steps = mix.c["epochs"] * judge.batch_geometry(mix.c)["steps"]
    n_trace = int(mix.t.get("trace_jobs", 1))
    jobs, t_open, last = [], None, 0.0
    tr = None
    j = 0
    while True:
        now = time.time()
        if jobs and (now - t_open) + last > seconds:
            break
        if tracer is not None and j == 0:
            tracer.start()
        tap.capture, tap.job = (3 if j in capture else 0), j
        tap.late_from = steps - 3 if j in capture else None
        with (tracer.job(str(j)) if tracer is not None else contextlib.nullcontext()):
            job = mix.run_encode(j)
        t_open = job.t0 if t_open is None else t_open
        if jobs and job.t1 - t_open > seconds:
            break  # ended past the window: not counted
        jobs.append(job)
        if tracer is not None and j + 1 == n_trace:
            # a traced window is its traced jobs: reading the trace takes the rest
            tr = tracer.stop(sum(len(x.points) for x in jobs))
            break
        last = job.t1 - job.t0
        j += 1
    if tracer is not None and tr is None:
        tr = tracer.stop(sum(len(x.points) for x in jobs))
    tap.capture, tap.late_from = 0, None
    counted = {job.index for job in jobs}
    tap.records = [r for r in tap.records if r["job"] in counted]
    tap.evals = [e for e in tap.evals if e[0] in counted]
    for job in jobs:  # every fit of the window takes the configured steps
        job.steps = (tap.calls.get(job.index, 0), steps)
        job.kept = job.index in capture
    return jobs, jobs[-1].t1, tr


def decode_window(mix: Mix, seconds: float, tracer, seed: int):
    """Closed loop over `decode_pipelined_iter`: the streams round robin,
    fed while the window lasts; a stream counts where it is yielded within
    `seconds`.  The decodes at the positions the seed picks are kept for
    the judge."""
    from lbdrn_msic_tpu_torch.codec import decode_pipelined_iter

    t = mix.t
    rng = np.random.default_rng(seeds_of(seed, 1, 4))
    keep = set(int(i) for i in rng.choice(np.arange(1, int(t["sample_range"])),
                                          size=int(t["sample_points"]) - 1,
                                          replace=False)) | {0}
    n = len(mix.streams)
    n_trace = int(t.get("trace_jobs", n))
    state = {"fed": 0, "stop": False}

    def feed():
        while not state["stop"]:
            p = mix.streams[state["fed"] % n]
            state["fed"] += 1
            yield p.stream

    jobs, tr = [], None
    if tracer is not None:
        tracer.start()
    t_open = time.time()
    prev = t_open
    for i, (img, stats) in enumerate(decode_pipelined_iter(feed(), ahead=int(t["ahead"]),
                                                           device=mix.device)):
        now = time.time()
        if now - t_open > seconds:
            state["stop"] = True
            continue  # drained past the window: not counted
        src = mix.streams[i % n]
        jobs.append(Job(i, prev, now, [Point(src.scene, src.K, src.stream, stats)],
                        dict(stats.phases or {}), img if i in keep else None))
        prev = now
        if tracer is not None and tr is None and len(jobs) == n_trace:
            tr = tracer.stop(len(jobs))
        per_stream = (now - t_open) / len(jobs)
        if (now - t_open) + per_stream * (int(t["ahead"]) + 1) > seconds:
            state["stop"] = True
    if tracer is not None and tr is None:
        tr = tracer.stop(len(jobs))
    return jobs, jobs[-1].t1, tr


def decode_outputs(mix: Mix, jobs: list, seed: int, traffic: dict) -> dict:
    """After the window: the program decodes each distinct stream of an
    encode window (untimed) for the quality means; every point of the
    first job and of the jobs the seed picks keeps its decode for the
    judge."""
    from lbdrn_msic_tpu_torch.codec import decode_stream

    points = [p for j in jobs for p in j.points]
    if mix.entry == "decode":
        kept = [(p, j.decoded) for j in jobs for p in j.points if j.decoded is not None]
        return {"attempted": len(points), "kept": kept, "quality": {}}
    rng = np.random.default_rng(seeds_of(seed, 1, 5))
    n_s = min(int(traffic["sample_jobs"]), len(jobs))
    picked = {0} | set(int(i) for i in rng.choice(np.arange(1, max(len(jobs), 2)),
                                                  size=n_s - 1, replace=False)
                       if i < len(jobs))
    sample = {id(p) for j in jobs if j.index in picked for p in j.points}
    by_hash, psnrs, rates, kept = {}, [], [], []
    from reference.frozen import bpsp, psnr
    for i, p in enumerate(points):
        h = hashlib.sha256(p.stream).digest()
        if h not in by_hash:
            by_hash[h] = decode_stream(p.stream, device=mix.device)[0]
        img = mix.scenes[p.scene]
        psnrs.append(psnr(img, by_hash[h]))
        rates.append(bpsp(len(p.stream), img.shape))
        if id(p) in sample:
            kept.append((p, by_hash[h]))
    return {"attempted": len(points), "kept": kept,
            "quality": {"psnr_db": float(np.mean(psnrs)), "bpsp": float(np.mean(rates))}}


def breakdown(tr: Trace) -> dict:
    by = {}
    for name, a, b in tr.kernels:
        by[name] = by.get(name, 0.0) + (b - a)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in tr.gaps[:10]]}
