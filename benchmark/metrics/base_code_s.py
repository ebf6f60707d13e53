"""base_code_s: seconds a point of the base coder's own work, from the
program's phase `base_code` (the base layer coded on its worker thread,
`codec.py`, while the host issues the fit's steps; `codecs/` jp2 or lpc),
summed over the job's coders."""


def read(run):
    jobs = [j for j in run.jobs if j.phases and "base_code" in j.phases]
    if not jobs:
        return None
    return sum(j.phases["base_code"] for j in jobs) / sum(len(j.points) for j in jobs)
