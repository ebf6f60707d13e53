"""eval_roofline: the eval forward's share of the card's f32 peak, in %:
one forward over the scene a point and epoch (none at one epoch, as
`encode_mfu` counts), at the frozen `forward_ops` at the real widths,
over the evals' device seconds, the program's phase `eval_device` (CUDA
events around each eval, `train/loop.py`)."""

from reference.frozen import forward_ops


def read(run):
    if run.traffic["entry"] == "decode":
        return None
    jobs = [j for j in run.jobs if j.phases and j.phases.get("eval_device", 0.0) > 0]
    if not jobs:
        return None
    c = run.config
    evals = c["epochs"] if c["epochs"] > 1 else 0
    ops = sum(len(j.points) for j in jobs) * evals \
        * forward_ops(c["scene_rows"] * c["scene_cols"], run.step_cost_dims())
    seconds = sum(j.phases["eval_device"] for j in jobs)
    return 100.0 * ops / (seconds * run.peaks()["f32"])
