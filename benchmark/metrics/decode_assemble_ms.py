"""decode_assemble_ms: milliseconds a stream of fetching the residual
bitplanes and assembling the image on the host, from the program's phase
`fetch_assemble`."""


def read(run):
    jobs = [j for j in run.jobs if j.phases and "fetch_assemble" in j.phases]
    if not jobs or run.traffic["entry"] != "decode":
        return None
    return 1e3 * sum(j.phases["fetch_assemble"] for j in jobs) / len(jobs)
