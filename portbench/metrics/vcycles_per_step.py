"""V-cycles of mg.v_cycle and nodal.v_cycle entered at the finest level,
per window step (every step of the traced run's window)."""


def read(run):
    if not run.steps or run.vcycles is None:
        return None
    return run.vcycles / len(run.steps)
