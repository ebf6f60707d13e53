"""decode_wait_ms: milliseconds a stream that the caller's thread of
`decode_pipelined_iter` waits on its dispatch worker (the base and weight
decodes and the device dispatch of the stream), from the program's phase
`dispatch_wait`."""


def read(run):
    jobs = [j for j in run.jobs if j.phases and "dispatch_wait" in j.phases]
    if not jobs or run.traffic["entry"] != "decode":
        return None
    return 1e3 * sum(j.phases["dispatch_wait"] for j in jobs) / len(jobs)
