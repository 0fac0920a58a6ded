"""How ``correct`` is decided: the reference (reference/vtref, the port's
plain path frozen, in float64) against what the program produced.

Two checks, each of the program's own output:

- start: the state after set-up's initialization (the initial projection
  and ``init_iter`` pressure iterations; on the AMR cell the hierarchy,
  which the reference builds again, and its initial projection), from the
  same seeded initial state;
- step: the window step drawn from the seed (traffic.check_step), from
  the program's own state before it (velocity, scalars, pressure and its
  gradient, the warm starts, dt and the step count): the reference takes
  its own dt and steps once.

Each number is the largest gap between the program's field and the
reference's, over the levels, relative to the reference field's largest
|value| (absolute where that is 0), or (``start.dt``) the relative gap of
the first dt. The step's own dt is not compared apart: the float32
control reads it equal, and the step's fields carry it. An AMR cell's
``hierarchy`` is 0 where the two hierarchies are equal, else 1.
"""
from __future__ import annotations

import gc

import torch

from . import traffic as traffic_mod
from .reference import initdata as ref_init
from .reference.vtref.config import VardenConfig as RefConfig
from .reference.vtref.driver import Varden as RefVarden
from .reference.vtref.state import State as RefState

FIELDS = ("u", "s", "gp", "p")


def gap(got, ref):
    """max|got - ref| / max|ref| in float64 on ref's device (absolute
    where ref is 0); inf if shapes differ or got is not finite."""
    got = got.to(ref.device, torch.float64)
    if got.shape != ref.shape:
        return float("inf")
    d = float((got - ref).abs().max()) if got.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    if d != d:
        return float("inf")
    return d / scale if scale > 0.0 else d


def _fields_gap(tag, got_levels, ref_levels):
    """{tag.field: worst gap over levels}; got_levels are host dicts."""
    out = {}
    for f in FIELDS:
        out[f"{tag}.{f}"] = max(gap(g[f], getattr(r, f))
                               for g, r in zip(got_levels, ref_levels))
    return out


def _to_state(d, device):
    return RefState(**{f: d[f].to(device, torch.float64) for f in FIELDS})


def _ref(kw, device):
    """A reference Varden on ``device`` in float64 that prints nothing."""
    v = RefVarden(RefConfig(**dict(kw, dtype="float64")), device=device)
    v._report = lambda *a, **k: None
    return v


def start(cell, seed, snap, device):
    """The start check; returns (numbers, the reference's hierarchy or
    None)."""
    kw = cell.settings("float64")
    spec = cell.traffic["perturbation"]
    ref = _ref(kw, device)
    if not cell.multilevel:
        u, s, gp, p = ref_init.initdata(kw, device)
        n = tuple(u.shape[1:])
        u = traffic_mod.perturb_levels(seed, spec, kw, [((0,) * 3, n)], [u],
                                       device)[0]
        states = [ref.initialize(RefState(u=u, s=s, gp=gp, p=p))]
        geom = None
    else:
        states = ref.initialize_ml()
        geom = ref.geom
        boxes = [(tuple(sp.lo), tuple(sp.n)) for sp in geom.specs]
        us = traffic_mod.perturb_levels(seed, spec, kw, boxes,
                                        [st.u for st in states], device)
        states = [RefState(u=u, s=st.s, gp=st.gp, p=st.p)
                  for u, st in zip(us, states)]
    out = {}
    if geom is not None:
        same = hierarchy_key(geom) == snap["hierarchy"]
        out["hierarchy"] = 0.0 if same else 1.0
        if not same:
            return dict(out, **{f"start.{f}": float("inf")
                                for f in FIELDS + ("dt",)}), None
    out.update(_fields_gap("start", snap["levels"], states))
    out["start.dt"] = abs(snap["dt"] - ref.dt) / abs(ref.dt)
    del states, ref
    return out, geom


def hierarchy_key(geom):
    return ([(tuple(sp.lo), tuple(sp.n)) for sp in geom.specs],
            list(geom.parent), list(geom.depth))


def step(cell, pre, post, device, geom=None):
    """The step check from the program's state before the checked step
    (``pre``) against the program's state after it (``post``)."""
    kw = cell.settings("float64")
    ref = _ref(kw, device)
    ref.istep, ref.time, ref.dt = pre["istep"], pre["time"], pre["dt"]
    states = [_to_state(d, device) for d in pre["levels"]]
    h = {k: ([t.to(device, torch.float64) for t in v] if isinstance(v, list)
             else v.to(device, torch.float64))
         for k, v in pre["hints"].items()}
    if geom is None:
        ref._hints = h
        states = [ref.step(states[0])]
    else:
        ref.geom, ref._ml_hints = geom, h
        states = ref.step_ml(states)
    return _fields_gap("step", post["levels"], states)


def run_checks(cell, seed, start_snap, pre, post, device):
    """Both checks, the reference's memory freed after each."""
    numbers, geom = start(cell, seed, start_snap, device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if cell.multilevel and geom is None:
        numbers.update({f"step.{f}": float("inf") for f in FIELDS})
        return numbers
    numbers.update(step(cell, pre, post, device, geom))
    return numbers


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]): every number at or below its
    limit; no limits (a cell not yet calibrated) is not correct."""
    rows = [(k, v, None if limits is None else limits.get(k))
            for k, v in numbers.items()]
    ok = limits is not None and all(
        lim is not None and v <= lim for _, v, lim in rows)
    return ok, rows
