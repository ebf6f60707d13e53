"""bpsp: the mean over the window's points of the stream's bits over the
scene's sub-pixels."""


def read(run):
    return run.quality.get("bpsp")
