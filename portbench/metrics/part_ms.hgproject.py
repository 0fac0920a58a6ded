"""Host ms a traced step spends inside the port's step::hgproject range
(advance.RANGES; the nodal projection of advance_timestep / ml_advance)."""


def read(run):
    t = run.trace
    if t is None or "step::hgproject" not in t["ranges_s"]:
        return None
    return t["ranges_s"]["step::hgproject"] / t["steps"] * 1e3
