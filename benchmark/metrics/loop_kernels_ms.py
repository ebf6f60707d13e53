"""loop_kernels_ms: device milliseconds a point of every operation in the
traced jobs other than the fused step's kernels (K1-K4): the evals'
forward, batch staging and assembly, copies."""

K12 = ("step_partials", "step_adam", "multi_step")


def read(run):
    tr = run.trace
    if tr is None or not tr.points or run.traffic["entry"] == "decode":
        return None
    other = sum(b - a for name, a, b in tr.kernels if not any(k in name for k in K12))
    return other * 1e3 / tr.points if other > 0 else None
