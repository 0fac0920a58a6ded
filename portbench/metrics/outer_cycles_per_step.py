"""Outer cycles of the composite AMR solves per window step:
mac_outer + hg_outer + the sum of visc_outer of Varden.last_diag."""


def read(run):
    outer = [r["outer"] for r in run.steps if r.get("outer") is not None]
    if not outer or len(outer) != len(run.steps):
        return None
    return sum(outer) / len(outer)
