"""stage_ms: device milliseconds a point of the fit's staging, from the
program's phase `stage_device` (CUDA events around `train/loop.py`'s
`stage` block: the plane, the tap matrix or feature cache, the labels,
the buffers, up to the init's upload)."""


def read(run):
    jobs = [j for j in run.jobs if j.phases and "stage_device" in j.phases]
    if not jobs:
        return None
    return 1e3 * sum(j.phases["stage_device"] for j in jobs) / sum(len(j.points) for j in jobs)
