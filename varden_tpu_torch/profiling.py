"""Profiling and tracing (counterpart of varden_tpu.profiling).

The port's one span primitive, its one counter type, and the reference's
bl_prof summary and per-step phase "Timing summary"
(advance_timestep.f90:150-166, main.f90:17-29):

  * ``span(name)``: a named host interval. While torch.profiler runs it is
    a ``record_function`` range, on the device trace's clock; while the
    summary is on (``reset()``) its host seconds go into ``report()``'s
    bl_prof_res-style table; otherwise it is a shared null context after
    one flag check. Every name is declared once, in ``SPANS``, which is
    ``advance.RANGES``; ``span`` refuses any other;
  * ``counter(name)``: the registry of ``Counter``s (calls, bytes,
    elements, host seconds), always on: ``vcycles.mg`` / ``vcycles.nodal``
    (V-cycles entered at the finest level), ``host_reads.<site>`` (the
    device-to-host reads a step waits for, through ``read`` and
    ``library_read``) and ``parallel.halo``'s ``halo.exchanges``,
    ``halo.reductions`` and ``halo.copies``. ``Varden.step`` and
    ``step_ml`` bracket each step with ``begin_step`` / ``end_step``,
    which appends the step's counts to ``HISTORY``;
  * ``profile_phases`` / ``profile_phases_ml``: the phases of one
    timestep run apart, each timed over ``n_rep`` calls, and the
    reference's summary printed;
  * ``trace``: a torch.profiler scope that writes a Chrome trace.

The phases are built from the helpers advance_timestep and ml_advance use
(embed_faces, _level_max, the Godunov kernels with the level's umax), so
they run on a decomposed Sim or hierarchy too. On the card a phase is
timed with CUDA events recorded on the current stream around its
``n_rep`` calls; on the CPU with the host clock.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict

import torch
from torch.autograd.profiler import record_function

# Every span of the port. The six step:: ranges part a timestep; the rest
# isolate what the host does inside a step's solves, so that a traced run
# can tell where the device waited for it (a span goes around a solve, a
# V-cycle or a phase of one, never around a single kernel call).
SPANS = ("step::velpred", "step::macproject", "step::scalar_advance",
         "step::velocity_advance", "step::visc_solve", "step::hgproject",
         "step::estdt",
         "mg::build", "mg::vcycle", "mg::coarse", "mg::converge",
         "mg::sweeps",
         "nodal::build", "nodal::vcycle", "nodal::coarse", "nodal::converge")
_SPAN_NAMES = frozenset(SPANS)

# whether torch.profiler is recording: one call into torch's C library
profiler_on = torch._C._autograd._profiler_enabled

NULL = contextlib.nullcontext()
_summary_on = False
_records: Dict[str, list] = defaultdict(list)


class _Span:
    """An open span: a record_function range while the profiler runs, the
    summary's host seconds while it is on."""
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = record_function(self.name) if profiler_on() else None
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter() if _summary_on else None
        return self

    def __exit__(self, *exc):
        if self.t0 is not None:
            _records[self.name].append(time.perf_counter() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """``with profiling.span("mg::vcycle"):`` (a name of SPANS)."""
    if name not in _SPAN_NAMES:
        raise KeyError(f"span {name!r} is not in profiling.SPANS")
    if _summary_on or profiler_on():
        return _Span(name)
    return NULL


def reset(on: bool = True):
    """Clear the summary and switch it on (``on`` False: off, spans then
    time nothing)."""
    global _summary_on
    _records.clear()
    _summary_on = on


def report() -> str:
    """bl_prof_glean-style aggregate of the spans since ``reset()``
    (main.f90:27-29)."""
    lines = ["%-28s %8s %12s %12s" % ("REGION", "COUNT", "TOTAL(s)", "MEAN(s)")]
    for name, ts in sorted(_records.items(), key=lambda kv: -sum(kv[1])):
        lines.append("%-28s %8d %12.6f %12.6f"
                     % (name, len(ts), sum(ts), sum(ts) / len(ts)))
    return "\n".join(lines)


class Counter:
    """Calls, bytes, elements and host seconds."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.count = 0
        self.bytes = 0
        self.elements = 0
        self.seconds = 0.0

    def as_dict(self):
        return {"count": self.count, "bytes": self.bytes,
                "elements": self.elements, "seconds": self.seconds}


COUNTERS: Dict[str, Counter] = {}


def counter(name: str) -> Counter:
    """The registered Counter ``name``, made on first use."""
    c = COUNTERS.get(name)
    if c is None:
        c = COUNTERS[name] = Counter()
    return c


def read(t, site: str):
    """``t.tolist()``: a device tensor's value on the host, which waits for
    the device. Counts one read and its bytes at ``host_reads.<site>``; a
    host number passes through uncounted."""
    if not torch.is_tensor(t):
        return t
    c = counter("host_reads." + site)
    c.count += 1
    c.bytes += t.numel() * t.element_size()
    return t.tolist()


def library_read(site: str):
    """``with profiling.library_read(site):`` around a library call that
    reads the device on the host inside (torch.linalg.solve reads its error
    status): one read at ``host_reads.<site>``."""
    counter("host_reads." + site).count += 1
    return NULL


# The counts of the last HISTORY_STEPS steps, oldest first: one dict a step
# of each counter's calls in it, counters that did not move left out.
HISTORY_STEPS = 4096
HISTORY = collections.deque(maxlen=HISTORY_STEPS)
_step_start: Dict[str, int] = {}


def begin_step():
    """Mark the counters at a step's start."""
    global _step_start
    _step_start = {k: c.count for k, c in COUNTERS.items()}


def end_step():
    """Append the counts since ``begin_step`` to HISTORY."""
    entry = {}
    for k, c in COUNTERS.items():
        d = c.count - _step_start.get(k, 0)
        if d:
            entry[k] = d
    HISTORY.append(entry)


@contextlib.contextmanager
def trace(logdir: str):
    """A torch.profiler scope (CPU activity, and the card's where there is
    one); writes ``trace.json`` (Chrome trace format) into ``logdir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _time_phase(fn: Callable, args, n_rep: int, device) -> float:
    """Mean seconds of fn(*args) over n_rep calls, after one warm-up call."""
    fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        stream = torch.cuda.current_stream(device)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(stream)
        for _ in range(n_rep):
            fn(*args)
        e1.record(stream)
        e1.synchronize()
        return e0.elapsed_time(e1) / 1e3 / n_rep
    t0 = time.perf_counter()
    for _ in range(n_rep):
        fn(*args)
    return (time.perf_counter() - t0) / n_rep


def _summary(header: str, phases: Dict[str, float], io: bool):
    if io:
        print(header)
        for k, v in phases.items():
            print(f"  {k}: {v:.6f} seconds")


def phase_fns(sim) -> Dict[str, Callable]:
    """The four phases of one single-level timestep as functions, as
    varden_tpu's profile_phases composes them (lapu = 0, zero scalar
    forces, the regular-timestep nodal projection):

      premac(state, dt) -> umac          Godunov MAC prediction
      mac(state, umac) -> macproject's tuple (umac first)
      scalar(state, umac, dt) -> snew    edge states, then basic.update
      hg(state, snew, dt) -> hgproject's tuple

    3-D: kernel 1; kernel 11 then basic.update (kernel 6). 2-D: kernel 9;
    kernel 10 then the plain update."""
    from . import projection
    from .advance import _level_max, embed_faces
    from .ops import basic, cuda_godunov

    cfg = sim.cfg
    dm, ng, n = sim.dm, sim.ng, sim.n_cell
    adv_bc_vel = [sim.adv_bc[d] for d in range(dm)]
    adv_bc_scal = [sim.adv_bc[sim.scal_comp(i)] for i in range(sim.nscal)]
    is_cons = [True] + [False] * (sim.nscal - 1)

    def premac(state, dt):
        vf = basic.mkvelforce(cfg.ext_force, state.s, state.gp, None,
                              cfg.visc_coef, 1.0, cfg.boussinesq)
        velpred = (cuda_godunov.velpred_2d_fused if dm == 2
                   else cuda_godunov.velpred_3d_fused)
        return velpred(sim.fill_vel(state.u), sim.fill_extrap(vf, ng), dt,
                       sim.dx, sim.phys_bc, adv_bc_vel, ng, n,
                       cfg.slope_order, cfg.use_minion,
                       umax=_level_max(sim, state.u))

    def mac(state, umac):
        return projection.macproject(sim, umac, state.s[0])

    def scalar(state, umac, dt):
        # the scalar forces and mac_rhs are zero (lapu = laps = 0): None
        s_pad = sim.fill_scal(state.s)
        mp = embed_faces(sim, umac, ng)
        umax = _level_max(sim, torch.stack([f.abs().max() for f in umac]))
        tail = (dt, sim.dx, sim.phys_bc, adv_bc_scal, ng, n, False, is_cons,
                cfg.slope_order, cfg.use_minion)
        if dm == 2:
            ex, ey, fx, fy = cuda_godunov.mkflux_2d_fused(
                s_pad, mp[0], mp[1], None, None, *tail, umax=umax)
            sedge, sflux = (ex, ey), (fx, fy)
        else:
            sedge, sflux = cuda_godunov.mkflux_3d_fused(
                s_pad, mp, None, None, *tail, umax=umax)
        return basic.update(state.s, umac, sedge, sflux, None, dt, sim.dx,
                            is_cons)

    def hg(state, snew, dt):
        rhohalf = basic.make_at_halftime(state.s[0], snew[0])
        return projection.hgproject(sim, projection.REGULAR_TIMESTEP,
                                    state.u, state.u, rhohalf, state.p,
                                    state.gp, dt)

    return {"premac": premac, "mac": mac, "scalar": scalar, "hg": hg}


def profile_phases(sim, state, dt, n_rep: int = 3) -> Dict[str, float]:
    """Per-phase seconds of one single-level timestep (phase_fns), each
    phase run once as warm-up and then timed over n_rep calls: the
    reference's per-step timing summary (advance_timestep.f90:150-166).
    Printed on rank 0 under a decomposition. Returns {phase: seconds}."""
    from .parallel import mesh
    f = phase_fns(sim)
    umac = f["premac"](state, dt)
    umac2 = f["mac"](state, umac)[0]
    snew = f["scalar"](state, umac2, dt)
    dev = state.u.device
    phases = {
        "Velocity update (premac)": _time_phase(f["premac"], (state, dt),
                                                n_rep, dev),
        "MAC Projection": _time_phase(f["mac"], (state, umac), n_rep, dev),
        "Scalar update": _time_phase(f["scalar"], (state, umac2, dt), n_rep,
                                     dev),
        "HG Projection": _time_phase(f["hg"], (state, snew, dt), n_rep, dev),
    }
    _summary("Timing summary:", phases, mesh.is_io_proc())
    return phases


def phase_fns_ml(geom) -> Dict[str, Callable]:
    """The three phases of one multi-level timestep as varden_tpu's
    profile_phases_ml composes them: premac(states, dt) (the Godunov
    predictor on every level, each level's force padded beside zero
    forces on the others, then edge_restrict_mac), mac(states, umac_l)
    (macproject_ml) and hg(states, dt) (hgproject_ml of the t^n velocity
    with rhohalf = rho^n)."""
    from . import projection
    from .amr import advance_ml
    from .amr.fill import pad_ml_multi
    from .ops import basic, cuda_godunov

    sim = geom.sim
    cfg = sim.cfg
    dm, ng, nlev = geom.dm, sim.ng, geom.nlev
    vel_comps = list(range(dm))
    velpred = (cuda_godunov.velpred_2d_fused if dm == 2
               else cuda_godunov.velpred_3d_fused)

    def premac(states, dt):
        u_l = [st.u for st in states]
        umac_l = []
        for l in range(nlev):
            vf = basic.mkvelforce(cfg.ext_force, states[l].s, states[l].gp,
                                  None, cfg.visc_coef, 1.0, cfg.boussinesq)
            vf_pad = pad_ml_multi(geom, [vf if i == l else torch.zeros_like(
                u_l[i]) for i in range(nlev)], [sim.extrap_comp] * dm, l, ng)
            umac_l.append(velpred(
                pad_ml_multi(geom, u_l, vel_comps, l, ng), vf_pad, dt,
                geom.dx(l), geom.phys_bc_block(l),
                geom.adv_bc_block(l, vel_comps), ng, geom.bn(l),
                cfg.slope_order, cfg.use_minion,
                umax=advance_ml._block_max(geom, u_l[l])))
        return advance_ml.edge_restrict_mac(geom, umac_l)

    def mac(states, umac_l):
        return advance_ml.macproject_ml(geom, umac_l,
                                        [st.s for st in states])

    def hg(states, dt):
        u_l = [st.u for st in states]
        return advance_ml.hgproject_ml(
            geom, projection.REGULAR_TIMESTEP, u_l, u_l,
            [st.s[0] for st in states], [st.p for st in states],
            [st.gp for st in states], dt)

    return {"premac": premac, "mac": mac, "hg": hg}


def profile_phases_ml(geom, states, dt, n_rep: int = 3) -> Dict[str, float]:
    """Per-phase seconds of one multi-level timestep (phase_fns_ml), timed
    as profile_phases times its phases; the reference prints the same
    summary whatever nlevs (advance_timestep.f90:150-166). Returns
    {phase: seconds}."""
    from .parallel import mesh
    f = phase_fns_ml(geom)
    umac_l = f["premac"](states, dt)
    dev = states[0].u.device
    phases = {
        "Velocity update (premac, all levels)": _time_phase(
            f["premac"], (states, dt), n_rep, dev),
        "MAC Projection (composite)": _time_phase(
            f["mac"], (states, umac_l), n_rep, dev),
        "HG Projection (composite)": _time_phase(
            f["hg"], (states, dt), n_rep, dev),
    }
    _summary(f"Timing summary ({geom.nlev} patches, {geom.ndepth} levels):",
             phases, mesh.is_io_proc())
    return phases
