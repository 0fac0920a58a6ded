"""Device idle ms a traced step in the gaps the host spent inside the
port's mg::build or nodal::build spans (a solve's multigrid hierarchy
built, its dense bottom inverse included): the time the card waited for
the hierarchy builds. None where the program has no such span."""

SPANS = ("mg::build", "nodal::build")


def read(run):
    t = run.trace
    if t is None or not any(k in t["ranges_s"] for k in SPANS):
        return None
    return sum(t["idle_by_range"].get(k, 0.0) for k in SPANS) \
        / t["steps"] * 1e3
