"""staged_gb: GB a point that the fit staged on the device for its
batches (the program's counter `staged_bytes` of each tile: the f32
feature cache for "cached", the integer tap matrix for "full", the row
taps for "banded"; a rate sweep's or a chunk's points each carry their
group's)."""


def read(run):
    if run.traffic["entry"] == "decode":
        return None
    points = [p for j in run.jobs for p in j.points
              if getattr(getattr(p, "stats", None), "tiles", None)]
    if not points:
        return None
    return sum(t.staged_bytes for p in points for t in p.stats.tiles) / 1e9 / len(points)
