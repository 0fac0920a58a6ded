"""Share of the traced steps' host wall in which no operation ran on the
device: 1 - (union of the profiler's device intervals) / wall, in %."""


def read(run):
    t = run.trace
    if t is None or t["wall_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
