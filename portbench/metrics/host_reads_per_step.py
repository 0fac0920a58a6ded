"""Device-to-host reads a window step waits for, as the program counts
them: the mean over the window's steps of the host_reads.* counters in
varden_tpu_torch.profiling's per-step history (the last len(run.steps)
entries). None where the program keeps no such history, or it holds
fewer entries than the window has steps."""
import sys


def read(run):
    prof = sys.modules.get("varden_tpu_torch.profiling")
    hist = getattr(prof, "HISTORY", None)
    n = len(run.steps)
    if hist is None or n == 0 or len(hist) < n:
        return None
    window = list(hist)[-n:]
    return sum(c for entry in window for k, c in entry.items()
               if k.startswith("host_reads.")) / n
