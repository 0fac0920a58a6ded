"""Host ms a traced step spends inside the port's step::macproject range
(advance.RANGES; the MAC projection of advance_timestep / ml_advance)."""


def read(run):
    t = run.trace
    if t is None or "step::macproject" not in t["ranges_s"]:
        return None
    return t["ranges_s"]["step::macproject"] / t["steps"] * 1e3
