"""Device operations a traced step launches: every kernel, copy and set
in the profiler's trace, the port's kernels and PyTorch's alike."""


def read(run):
    t = run.trace
    if t is None:
        return None
    return t["ops"] / t["steps"]
