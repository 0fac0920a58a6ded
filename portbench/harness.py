"""One run of one cell: set-up, the measured window, the traced steps, the
reference's checks, and the result line's contents.

The window drives ``varden_tpu_torch.driver.Varden.step`` (one level,
after ``Varden.initialize`` of the benchmark's seeded initial state) or
``Varden.step_ml`` (AMR, after ``initialize_ml`` and the seeded
perturbation of every level): a closed loop of one run's steps back to
back, each ending in ``torch.cuda.synchronize()``.

The harness's own copies of the program's state to the host (for the
reference, after set-up and around the checked step) are timed and left
out of ``setup_s`` and of the window.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import math
import os
import subprocess
import sys
import time

import torch

from . import check, gates, stats
from . import trace as trace_mod
from . import traffic as traffic_mod
from .cell import HERE
from .reference import initdata as ref_init

FORBIDDEN = ("jax", "jaxlib", "flax", "varden_tpu")


class Clock:
    """perf_counter from a start, less the harness's own pauses."""

    def __init__(self, t0=None):
        self.t0 = time.perf_counter() if t0 is None else t0
        self.paused = 0.0

    def now(self):
        return time.perf_counter() - self.t0 - self.paused

    @contextlib.contextmanager
    def pause(self):
        a = time.perf_counter()
        try:
            yield
        finally:
            self.paused += time.perf_counter() - a


class Port:
    """The program's modules a run uses, imported at run time."""

    def __init__(self):
        from varden_tpu_torch import advance
        from varden_tpu_torch.config import VardenConfig
        from varden_tpu_torch.driver import Varden
        from varden_tpu_torch.ops import _cuda, cuda_godunov
        from varden_tpu_torch.solvers import mg, nodal
        from varden_tpu_torch.state import State
        self.advance, self.VardenConfig, self.Varden = advance, VardenConfig, Varden
        self._cuda, self.cuda_godunov = _cuda, cuda_godunov
        self.mg, self.nodal, self.State = mg, nodal, State


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _host(t):
    return t.detach().to("cpu", copy=True)


def _host_levels(states):
    return [{f: _host(getattr(st, f)) for f in check.FIELDS} for st in states]


def _host_hints(h):
    return {k: ([_host(t) for t in v] if isinstance(v, list) else _host(v))
            for k, v in h.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def initial_states(port, v, cell, seed, device):
    """Set-up's initialization: the seeded initial state through
    Varden.initialize (one level), or initialize_ml and the seeded
    perturbation of every level (AMR). Returns the list of level States."""
    kw = cell.settings()
    spec = cell.traffic["perturbation"]
    if not cell.multilevel:
        u, s, gp, p = ref_init.initdata(kw, device)
        n = tuple(u.shape[1:])
        u = traffic_mod.perturb_levels(seed, spec, kw, [((0,) * 3, n)], [u],
                                       device)[0]
        dt = v.sim.dtype
        st = port.State(u=u.to(dt), s=s.to(dt), gp=gp.to(dt), p=p.to(dt))
        return [v.initialize(st)]
    states = v.initialize_ml()
    boxes = [(tuple(sp.lo), tuple(sp.n)) for sp in v.geom.specs]
    us = traffic_mod.perturb_levels(seed, spec, kw, boxes,
                                    [st.u for st in states], device)
    return [port.State(u=u, s=st.s, gp=st.gp, p=st.p)
            for u, st in zip(us, states)]


def _hints(v):
    h = (v._ml_hints if v.ml else v._hints) or {}
    return {k: (list(t) if isinstance(t, list) else t) for k, t in h.items()}


def _snapshot(v, states, hints=None, dt=None, istep=None, time_=None):
    snap = {"levels": _host_levels(states),
            "hints": _host_hints(hints if hints is not None else _hints(v)),
            "dt": v.dt if dt is None else dt,
            "istep": v.istep if istep is None else istep,
            "time": v.time if time_ is None else time_}
    if v.ml:
        snap["hierarchy"] = check.hierarchy_key(v.geom)
    return snap


def _outer(diag):
    if "mac_outer" not in diag:
        return None
    return (int(diag["mac_outer"]) + int(diag["hg_outer"])
            + sum(int(k) for k in diag.get("visc_outer", [])))


def load_reader(name):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class RunView:
    """What the per-layer readers read."""

    def __init__(self, steps, vcycles, summary, godunov_bound_s):
        self.steps, self.vcycles = steps, vcycles
        self.trace, self.godunov_bound_s = summary, godunov_bound_s


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def run(cell, seed, seconds, traced, device=None, dtype=None, t0=None):
    """One run; returns the result line's dict. ``device`` None is the card
    (a test passes the CPU); ``dtype`` overrides the configuration's (the
    control); ``t0`` is the process's start on perf_counter."""
    clock = Clock(t0)
    device = torch.device("cuda" if device is None else device)
    port = Port()
    on_card = device.type == "cuda"
    if on_card:
        port._cuda.build_all()
        torch.cuda.reset_peak_memory_stats()
    cfg = port.VardenConfig(**cell.settings(dtype))
    dtype_name = cfg.dtype
    v = port.Varden(cfg, device=device)
    states = initial_states(port, v, cell, seed, device)
    _sync(device)
    with clock.pause():
        start_snap = _snapshot(v, states)
    step_fn = v.step_ml if v.ml else (lambda sts: [v.step(sts[0])])
    for _ in range(cell.traffic["warm_steps"]):
        states = step_fn(states)
    _sync(device)
    setup_s = clock.now()

    j = traffic_mod.check_step(seed, cell.traffic)
    k_trace = cell.traffic["trace_steps"] if traced else 0
    inst = trace_mod.Instruments(port, dtype_name) if traced else None
    prof, summary, pre, post = None, None, None, None
    records, failed = [], 0
    t_w0 = clock.now()
    i = 0
    try:
        while True:
            if i == j:
                pre = (list(states), _hints(v), v.dt, v.istep, v.time)
            if traced and i == j + 1:
                prof = _start_profiler()
                inst.recording = True
                t_tr0 = time.perf_counter()
            t_a = time.perf_counter()
            states = step_fn(states)
            _sync(device)
            t_b = time.perf_counter()
            diag = v.last_diag
            cells = v.geom.cells() if v.ml else math.prod(cfg.n_cell)
            bad = gates.step_failures(diag, cell.config["gates"])
            if bad:
                failed += 1
                print(f"step {v.istep}: gates {bad}", file=sys.stderr)
            records.append({"seconds": t_b - t_a, "cells": cells,
                            "outer": _outer(diag)})
            if traced and i == j + k_trace:
                inst.recording = False
                wall = time.perf_counter() - t_tr0
                t_read = time.perf_counter()
                prof.__exit__(None, None, None)
                summary = trace_mod.summarize(
                    trace_mod.profiler_events(prof), set(port.advance.RANGES),
                    k_trace, wall)
                summary["read_s"] = time.perf_counter() - t_read
                prof = None
            if i == j:
                with clock.pause():
                    pre = _snapshot(v, pre[0], pre[1], pre[2], pre[3], pre[4])
                    post = _snapshot(v, states)
            i += 1
            done = i > j and (not traced or i > j + k_trace)
            if done and clock.now() - t_w0 >= seconds:
                break
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if inst is not None:
            inst.remove()
    window_s = clock.now() - t_w0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    bad = gates.field_failures(states, cell.config["gates"])
    if bad:
        print(f"after the window: {bad}", file=sys.stderr)
        failed += 1
    step_s = [r["seconds"] for r in records]
    view = RunView(records, inst.vcycles if inst else None, summary,
                   inst.godunov_bound_s if inst else 0.0)
    del v, states
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    metrics = {}
    if traced:
        for m in cell.per_layer:
            val = load_reader(m["name"])(view)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        e2e = {"cells_per_s": stats.cells_per_s([r["cells"] for r in records],
                                                window_s),
               "step_ms_p90": stats.step_ms_p90(step_s),
               "peak_mem_gib": peak / 2 ** 30,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    t_check = time.perf_counter()
    numbers = check.run_checks(cell, seed, start_snap, pre, post, device)
    check_s = time.perf_counter() - t_check
    correct, rows = check.verdict(numbers, cell.limits)
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak,
                   "power_limit_w": power_limit() if on_card else None}
    if traced and summary is not None:
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["wall_s"])
    out = {"correct": correct, "attempted": len(records), "failed": failed,
           "metrics": metrics, "device": device_info}
    if traced and summary is not None:
        out["breakdown"] = trace_mod.breakdown(summary)
    out["detail"] = {"seed": seed, "dtype": dtype_name, "check_step": j,
                     "trace_read_s": summary["read_s"] if summary else None,
                     "window_s": window_s, "check_s": check_s,
                     "steps": len(records),
                     "step_s_min": min(step_s), "step_s_max": max(step_s)}
    out["compared"] = {k: {"value": val, "limit": lim}
                       for k, val, lim in rows}
    return out


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof
