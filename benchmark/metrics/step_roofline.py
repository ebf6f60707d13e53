"""step_roofline: the fused step's (K1/K2) share of its roofline in the
traced jobs: each launch's least time, max(operations / f32 peak,
bytes / HBM peak) by the frozen `step_cost` at the real input width for
every expert it steps, summed, over the union of those kernels' device
intervals (pass 2 opens during pass 1), in %."""

from reference.frozen import busy_union, param_count, step_cost

K12 = ("step_partials", "step_adam")


def read(run):
    tr = run.trace
    if tr is None or run.traffic["entry"] == "decode":
        return None
    spans = [(a, b) for name, a, b in tr.kernels if any(k in name for k in K12)]
    launches = sum(1 for name, _, _ in tr.kernels if "step_partials" in name)
    t = busy_union(spans)
    if not launches or t <= 0:
        return None
    dims = run.step_cost_dims()
    ops, nbytes = step_cost(run.config["batch_size"], dims, param_count(dims))
    E = len(run.jobs[0].points)  # the experts a launch steps: a job's points
    pk = run.peaks()
    bound = launches * E * max(ops / pk["f32"], nbytes / pk["hbm"])
    return 100.0 * bound / t
