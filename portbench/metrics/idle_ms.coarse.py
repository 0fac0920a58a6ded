"""Device idle ms a traced step in the gaps the host spent inside the
port's mg::coarse or nodal::coarse spans (a V-cycle's levels of at most
mg.CONST_FUSED_MAX_CELLS cells or nodes, and its bottom): the time the
card waited for the launch-bound part of the V-cycles. None where the
program has no such span."""

SPANS = ("mg::coarse", "nodal::coarse")


def read(run):
    t = run.trace
    if t is None or not any(k in t["ranges_s"] for k in SPANS):
        return None
    return sum(t["idle_by_range"].get(k, 0.0) for k in SPANS) \
        / t["steps"] * 1e3
