"""encode_mpx_s: the window's completed (scene, K) points, H*W/1e6 each,
over the window's seconds (host clock)."""


def read(run):
    if not run.jobs or run.traffic["entry"] == "decode":
        return None
    c = run.config
    return run.n_points() * c["scene_rows"] * c["scene_cols"] / 1e6 / run.window_s
