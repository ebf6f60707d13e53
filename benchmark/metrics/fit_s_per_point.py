"""fit_s_per_point: seconds a point of the fit's host side, from the
program's phases `dispatch` (upload, staging, steps queued) and
`train_wait` (blocking on the device's result)."""

NAMES = ("dispatch", "train_wait")


def read(run):
    jobs = [j for j in run.jobs if j.phases and "train_wait" in j.phases]
    if not jobs:
        return None
    total = sum(j.phases.get(n, 0.0) for j in jobs for n in NAMES)
    return total / sum(len(j.points) for j in jobs)
