"""host_codec_s: seconds a point of the codec's host coding after the fit,
from the program's phases: `weights_codec` + `base_wait`
(`encode_image`) or `finalize` (`encode_rate_points`, shared by a group's
points)."""

NAMES = ("weights_codec", "base_wait", "finalize")


def read(run):
    jobs = [j for j in run.jobs if j.phases and any(n in j.phases for n in NAMES)]
    if not jobs:
        return None
    total = sum(j.phases.get(n, 0.0) for j in jobs for n in NAMES)
    return total / sum(len(j.points) for j in jobs)
