"""device_idle.eval: the device's idle seconds that the trace labels
`eval` (the host issuing an eval and waiting on its MSE,
`train/loop.py`), over the traced window, in %.  0 where the program
records the phase and the device never idles inside it; nothing where it
records no such phase."""

PHASE = "eval"


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or run.traffic["entry"] == "decode":
        return None
    if not any(j.phases and PHASE in j.phases for j in run.jobs):
        return None
    return 100.0 * dict(tr.gaps).get(PHASE, 0.0) / tr.window_s
