"""decode_dispatch_ms: milliseconds a stream of the decode worker's host
base decode, weight decode and device dispatch, from the program's phases
`base_decode`, `dispatch` and `dispatch_pipelined`."""

NAMES = ("base_decode", "dispatch", "dispatch_pipelined")


def read(run):
    jobs = [j for j in run.jobs if j.phases and any(n in j.phases for n in NAMES)]
    if not jobs or run.traffic["entry"] != "decode":
        return None
    return 1e3 * sum(j.phases.get(n, 0.0) for j in jobs for n in NAMES) / len(jobs)
