"""encode_mfu: the model's operations in the window's jobs over what the
card's f32 peak gives in the window's seconds, in %.  Per point: its
steps (epochs x H*W / batch) at the frozen `step_cost` at the real input
width, and one forward over the scene each epoch (the eval; none at one
epoch)."""

from reference.frozen import forward_ops, param_count, step_cost


def read(run):
    if not run.jobs or run.traffic["entry"] == "decode":
        return None
    c = run.config
    dims = run.step_cost_dims()
    hw = c["scene_rows"] * c["scene_cols"]
    steps = c["epochs"] * (-(-hw // c["batch_size"]))
    evals = c["epochs"] if c["epochs"] > 1 else 0
    ops = steps * step_cost(c["batch_size"], dims, param_count(dims))[0] \
        + evals * forward_ops(hw, dims)
    return 100.0 * run.n_points() * ops / (run.window_s * run.peaks()["f32"])
