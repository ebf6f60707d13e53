"""step_issue_us: host microseconds a training step, from the program's
phase `steps` (one span an epoch: its batches, their staging and the step
calls issued, `train/loop.py`) over the steps the harness's tap counted in
the same jobs (a K2 call steps every expert at once and counts one; a
K3/K4 call counts its k)."""


def read(run):
    if run.traffic["entry"] == "decode":
        return None
    jobs = [j for j in run.jobs if j.phases and "steps" in j.phases and j.steps and j.steps[0]]
    if not jobs:
        return None
    return 1e6 * sum(j.phases["steps"] for j in jobs) / sum(j.steps[0] for j in jobs)
