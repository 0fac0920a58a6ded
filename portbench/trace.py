"""What a traced run (``--trace 1``) reads: counters that the benchmark
wraps around the port's functions for every step of the window, and a
torch.profiler trace of a stated number of whole steps inside it.

The counters: V-cycles of ``mg.v_cycle`` and ``nodal.v_cycle`` entered at
the finest level (the recursion and the composite solves call the
modules' globals, as tools/torch_step_compare.py counts them), and, while
the profiler runs, the bytes and operations of each call of the Godunov
kernels 1 and 2 (``cuda_godunov.velpred_3d_fused``,
``mkflux_update_3d_fused``). The trace is reduced to sums: device seconds
and launches by kernel, host seconds by ``step::`` range, device idle time
by the ``step::`` range the host was in.
"""
from __future__ import annotations

import collections
import inspect

from . import roofline

GODUNOV = {"velpred_3d_fused": roofline.velpred_call,
           "mkflux_update_3d_fused": roofline.mkflux_update_call}


class Instruments:
    """Wraps the port's module globals; ``remove`` puts them back."""

    def __init__(self, port, dtype_name):
        self.dtype_name = dtype_name
        self.vcycles = 0
        self.recording = False
        self.godunov_bound_s = 0.0
        self._saved = []
        self._wrap_cycles(port.mg, 4)
        self._wrap_cycles(port.nodal, 3)
        for name, count in GODUNOV.items():
            self._wrap_godunov(port.cuda_godunov, name, count)

    def _put(self, module, name, fn):
        self._saved.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def _wrap_cycles(self, module, lev_pos):
        orig = module.v_cycle

        def v_cycle(*a, **k):
            if k.get("lev", a[lev_pos] if len(a) > lev_pos else 0) == 0:
                self.vcycles += 1
            return orig(*a, **k)

        self._put(module, "v_cycle", v_cycle)

    def _wrap_godunov(self, module, name, count):
        orig = getattr(module, name)
        sig = inspect.signature(orig)

        def wrapper(*a, **k):
            out = orig(*a, **k)
            if self.recording:
                b = sig.bind(*a, **k)
                b.apply_defaults()
                nbytes, ops = count(b.arguments, out)
                self.godunov_bound_s += roofline.bound_s(nbytes, ops,
                                                         self.dtype_name)
            return out

        # the launch helper counts through the module's name
        wrapper.launches = orig.launches
        self._put(module, name, wrapper)

    def remove(self):
        for module, name, fn in reversed(self._saved):
            wrapped = getattr(module, name)
            if hasattr(wrapped, "launches"):
                fn.launches = wrapped.launches
            setattr(module, name, fn)
        self._saved = []


def kernel_name(name: str) -> str:
    """A device op's name without template arguments and parameters for
    the port's kernels (namespace vt), whole for every other op."""
    if "vt::" in name:
        return name.split("vt::", 1)[1].split("<")[0].split("(")[0]
    return name


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _range_at(ranges, t):
    """The innermost host range containing time t, or None."""
    best = None
    for name, a, b in ranges:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return None if best is None else best[0]


def summarize(events, ranges_names, steps, wall_s):
    """Sums over a trace of ``steps`` whole steps that took ``wall_s`` on
    the host's clock. ``events``: (name, is_device, start_us, end_us)."""
    dev, host = [], []
    for name, is_device, a, b in events:
        if name in ranges_names:
            if not is_device:
                host.append((name, a, b))
        elif is_device:
            dev.append((kernel_name(name), a, b))
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for name, a, b in dev:
        kernels[name][0] += (b - a) * 1e-6
        kernels[name][1] += 1
    merged = _union([(a, b) for _, a, b in dev])
    busy = sum(b - a for a, b in merged) * 1e-6
    idle = collections.defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        idle[_range_at(host, 0.5 * (e0 + s1)) or "outside step::"] += \
            (s1 - e0) * 1e-6
    ranges_s = collections.defaultdict(float)
    for name, a, b in host:
        ranges_s[name] += (b - a) * 1e-6
    return {"steps": steps, "wall_s": wall_s, "busy_s": busy,
            "ops": len(dev), "kernels": {k: tuple(v) for k, v in
                                         kernels.items()},
            "ranges_s": dict(ranges_s), "idle_by_range": dict(idle)}


def profiler_events(prof):
    """(name, is_device, start_us, end_us) of every event of a
    torch.profiler run."""
    from torch.autograd import DeviceType
    return [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start,
             e.time_range.end) for e in prof.events()]


def breakdown(summary, top=10):
    """The device ops that took most time and the idle time by host
    range, in seconds, for the result line."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])
    gaps = sorted(summary["idle_by_range"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k, v[0]] for k, v in ops[:top]],
            "idle_gaps": [[k, v] for k, v in gaps[:top]]}
