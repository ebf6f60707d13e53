"""device_idle.decode: as device_idle.encode, in a decode window."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or run.traffic["entry"] != "decode":
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
