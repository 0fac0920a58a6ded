"""The reference's regression workloads from the shipped inputs files
(counterpart of run_regression.py at the repo's root, which mirrors
Util/regression_testing/VARDEN-tests.ini).

Every workload's config is parsed from the reference-format namelist in
inputs/, then held to the physics invariants the reference's harness
eyeballs through plotfile diffs: bounded density, post-MAC divergence at
solver tolerance, finite fields. bubble-restart also mirrors the harness's
restartTest=1: rerun from chk00004 and require bitwise agreement with the
continuous run (VARDEN-tests.ini [bubble-restart]).

Usage:
    python -m varden_tpu_torch.regression [workload|all] [--full]
        [--device cpu] [--dtype float32|float64]

QUICK mode (the default) parses each inputs file verbatim, then applies the
documented overrides of WORKLOADS (the reference's own --key value
mechanism, probin.template:107-126), which cut step counts, grid sizes and
levels only; --full runs the files unchanged. The runs go on the card
unless ``--device cpu`` is given; without a card they fail. ``--dtype``
overrides the files' float64. Each workload prints its checks' numbers and
its wall seconds, steps and seconds a step. A workload stops at its first
failed check and the sweep goes on to the next; the exit is non-zero if any
workload failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
import time

import torch

from .config import load_config
from .driver import Varden

INPUTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "inputs")

# workload -> (inputs file, quick-mode overrides): run_regression.py's
# table. Quick overrides only shrink runtime (fewer steps / smaller grids /
# fewer levels); --full runs the shipped file verbatim like the reference
# harness does.
WORKLOADS = {
    "bubble-2d": ("inputs_2d-regt", {}),
    "bubble-3d": ("inputs_3d-regt",
                  {"n_cellx": 32, "n_celly": 32, "n_cellz": 32,
                   "max_levs": 2, "max_step": 8}),
    "bubble-restart": ("inputs-restart-regt",
                       {"n_cellx": 16, "n_celly": 16, "n_cellz": 16,
                        "max_levs": 2}),
    "advect-2d": ("inputs_advect_2d", {"max_step": 40}),
    "advect-3d": ("inputs_advect_3d",
                  {"n_cellx": 16, "n_celly": 16, "n_cellz": 16,
                   "max_levs": 2, "max_step": 10}),
    "rt-2d": ("inputs_RayleighTaylor_2d", {"max_step": 30}),
    "rt-3d": ("inputs_RayleighTaylor_3d",
              {"n_cellx": 16, "n_celly": 16, "n_cellz": 16,
               "max_step": 10, "init_iter": 1}),
    "vortex-3d": ("inputs_vortextube_3d", {"max_step": 10}),
}


class CheckFailed(AssertionError):
    """A workload broke one of the reference harness's invariants;
    ``numbers`` holds what the check read, as a passing check returns
    it."""

    def __init__(self, msg, numbers=None):
        super().__init__(msg)
        self.numbers = {} if numbers is None else numbers


def _require(cond, msg, numbers):
    if not cond:
        raise CheckFailed(msg, numbers)


def _load(name, full, **over):
    """The workload's config: the shipped file, the quick overrides unless
    ``full``, no plotfiles or checkpoints (bubble-restart exercises them),
    quiet solvers; then ``over`` (none for a quick or full run)."""
    path, quick = WORKLOADS[name]
    kw = {} if full else dict(quick)
    if name != "bubble-restart":
        kw.update(plot_int=-1, chk_int=-1)
    kw.update(mg_verbose=0)
    kw.update(over)
    return load_config(os.path.join(INPUTS, path), **kw)


def _levels(sts):
    return sts if isinstance(sts, list) else [sts]


def _host(t):
    return t.detach().double().cpu()


def _boxes(v):
    """The patches' (lo, n): the hierarchy's, or the one level's."""
    if v.geom is not None:
        return [(tuple(s.lo), tuple(s.n)) for s in v.geom.specs]
    return [((0,) * v.cfg.dm, tuple(v.cfg.n_cell))]


def _numbers(v, **more):
    """What every check reports: steps, time, post-MAC divergence and the
    patches, with ``more``."""
    return dict(more, steps=v.istep, time=v.time,
                div_after=float(v.last_diag["div_after"]), levels=_boxes(v))


def _check(v, sts, densfact):
    """Finite velocity and density inside [1, densfact] within 2% of the
    jump on every level. Godunov limiting is not multi-D bound-preserving:
    sharp interfaces (tanh(30 r), ~2 cells wide) over/undershoot by a small
    fraction of the density jump, as the reference's own min/max logs do."""
    tol = 0.02 * (densfact - 1.0)
    levels = _levels(sts)
    rho = [_host(st.s[0]) for st in levels]
    out = _numbers(v, rho=[(float(r.min()), float(r.max())) for r in rho])
    for lev, (st, (lo, hi)) in enumerate(zip(levels, out["rho"])):
        _require(bool(torch.isfinite(_host(st.u)).all()),
                 f"level {lev} u not finite", out)
        _require(lo > 1.0 - tol, f"level {lev} rho undershoot {lo}", out)
        _require(hi < densfact + tol, f"level {lev} rho overshoot {hi}",
                 out)
        print(f"  level {lev}: rho in [{lo:.6f}, {hi:.6f}]")
    print(f"OK: {v.istep} steps, t={v.time:.4f}, "
          f"div_after={out['div_after']:.2e}, "
          f"levels={[b[1] for b in out['levels']] if v.geom else 1}")
    return out


def bubble_2d(full=False, device=None, **over):
    """VARDEN-tests.ini [bubble-2d]: inputs_2d-regt (64^2, max_levs=4)."""
    v = Varden(_load("bubble-2d", full, **over), device=device)
    return _check(v, v.run(), 2.0)


def bubble_3d(full=False, device=None, **over):
    """VARDEN-tests.ini [bubble-3d]: inputs_3d-regt (64^3, max_levs=3)."""
    v = Varden(_load("bubble-3d", full, **over), device=device)
    return _check(v, v.run(), 10.0)


def _same_runs(full_run, re_run):
    """Every field of every level of the two runs' final states bitwise
    equal."""
    a_l, b_l = _levels(full_run), _levels(re_run)
    _require(len(a_l) == len(b_l), f"restart mismatch: {len(b_l)} levels "
                                   f"against {len(a_l)}", {})
    for lev, (a, b) in enumerate(zip(a_l, b_l)):
        for name in ("u", "s", "gp", "p"):
            x, y = getattr(a, name), getattr(b, name)
            _require(x.shape == y.shape and bool(torch.equal(x, y)),
                     f"restart mismatch: level {lev} {name}", {})


def bubble_restart(full=False, device=None, **over):
    """VARDEN-tests.ini [bubble-restart]: run inputs-restart-regt (8 steps,
    chk_int=4), restart from chk00004, require bitwise agreement. The run
    writes its plotfiles and checkpoints in a temporary directory, removed
    after it."""
    cfg = _load("bubble-restart", full, **over)
    workdir = tempfile.mkdtemp(prefix="varden_restart_")
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        v = Varden(cfg, device=device)
        full_run = v.run()
        cfg2 = dataclasses.replace(cfg, restart=4)
        v2 = Varden(cfg2, device=device)
        re_run = v2.run()
    finally:
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)
    out = _numbers(v, steps_run=v.istep + v2.istep - cfg2.restart,
                   restart=cfg2.restart)
    _require(v2.istep == v.istep, f"the restarted run stopped at step "
                                  f"{v2.istep}, not {v.istep}", out)
    try:
        _same_runs(full_run, re_run)
    except CheckFailed as e:
        raise CheckFailed(str(e), out) from None
    print("bubble-restart: OK (restart bitwise-equal to continuous run)")
    out.update(bitwise=True)
    return out


def _centroid_x(rho):
    """The x centroid, in cells, of a density's excess over 1."""
    w = _host(rho) - 1.0
    ix = torch.arange(w.shape[0], dtype=w.dtype).reshape(
        (-1,) + (1,) * (w.dim() - 1))
    return float((w * ix).sum() / max(float(w.sum()), 1e-30) + 0.5)


def advect_2d(full=False, device=None, **over):
    """inputs_advect_2d: prob_type 2, a bubble advected through INLET/OUTLET
    x at u_bc=1 (reference initdata.f90:160-176). Invariants: density
    bounds, divergence at tolerance, and the density blob moving downstream
    at about the inflow speed."""
    cfg = _load("advect-2d", full, **over)
    v = Varden(cfg, device=device)
    st0 = v.initialize_ml() if cfg.max_levs > 1 else v.initialize()
    x0 = _centroid_x(_levels(st0)[0].s[0])
    sts = v.run(state=None if cfg.max_levs > 1 else st0)
    out = _check(v, sts, 2.0)
    x1 = _centroid_x(_levels(sts)[0].s[0])
    out.update(centroid_shift=(x1 - x0) / cfg.n_cellx * 1.0,
               expected_shift=1.0 * v.time)
    _advect_shift(out)
    return out


def _advect_shift(out):
    """The blob's centroid moved downstream by about u_bc * t (within 30%:
    the blob deforms): ``out``'s centroid_shift against its
    expected_shift."""
    shift, expect = out["centroid_shift"], out["expected_shift"]
    _require(0.7 * expect < shift < 1.3 * expect,
             f"blob moved {shift:.4f}, expected ~{expect:.4f}", out)
    print(f"advect-2d: OK (blob advected {shift:.4f} vs u*t={expect:.4f})")


def advect_3d(full=False, device=None, **over):
    """inputs_advect_3d: the 3-D inflow/outflow bubble (prob_type 2)."""
    v = Varden(_load("advect-3d", full, **over), device=device)
    out = _check(v, v.run(), 2.0)
    print("advect-3d: OK")
    return out


def _rt_check(v, sts, name):
    """Finite density inside [1, 2] within 0.02 on every level, and a
    positive finite kinetic energy (sum of u^2) on the base level."""
    levels = _levels(sts)
    rho = [_host(st.s[0]) for st in levels]
    ke = float((_host(levels[0].u) ** 2).sum())
    out = _numbers(v, rho=[(float(r.min()), float(r.max())) for r in rho],
                   ke=ke)
    for lev, (r, (lo, hi)) in enumerate(zip(rho, out["rho"])):
        _require(bool(torch.isfinite(r).all()), f"level {lev} rho not "
                                                "finite", out)
        _require(lo > 1.0 - 0.02 and hi < 2.0 + 0.02,
                 f"level {lev} rho out of [1,2]: [{lo}, {hi}]", out)
    _require(ke > 0.0 and ke < float("inf"), f"kinetic energy {ke}", out)
    print(f"{name}: OK ({v.istep} steps, KE={ke:.3e}, "
          f"div_after={out['div_after']:.2e})")
    return out


def rt_2d(full=False, device=None, **over):
    """inputs_RayleighTaylor_2d: prob_type 3, heavy over light, periodic x,
    no-slip y walls (reference initdata.f90:177-200). Invariants: density
    stays within the two layer values; the instability converts potential
    energy into kinetic energy (KE positive)."""
    v = Varden(_load("rt-2d", full, **over), device=device)
    return _rt_check(v, v.run(), "rt-2d")


def rt_3d(full=False, device=None, **over):
    """inputs_RayleighTaylor_3d: the 3-D RT problem (periodic x/y)."""
    v = Varden(_load("rt-3d", full, **over), device=device)
    return _rt_check(v, v.run(), "rt-3d")


# the vortex tube's bounds: uniform density drift, kinetic energy growth
# (factor) and the post-MAC divergence
VORTEX_DRIFT = 2e-4
VORTEX_KE_GROWTH = 1.01
VORTEX_DIV = 1e-6 * 64


def _vortex_check(v, ke0, st):
    """Uniform density kept to the conservative scheme's truncation, no
    kinetic energy growth, divergence at tolerance."""
    rho = _host(st.s[0])
    # constant rho is preserved only to the conservative scheme's
    # truncation: the corner-coupled edge states carry O(dt * du) transverse
    # corrections whose flux divergence does not cancel exactly (~1e-7/step
    # here; the reference's scheme drifts identically)
    drift = abs(float(rho.max()) - float(rho.min()))
    ke1 = float((_host(st.u) ** 2).sum())
    out = _numbers(v, drift=drift, ke0=ke0, ke=ke1)
    _require(drift < VORTEX_DRIFT, f"uniform density drifted: {drift:.3e}",
             out)
    _require(ke1 < ke0 * VORTEX_KE_GROWTH, f"KE grew: {ke0} -> {ke1}", out)
    div = out["div_after"]
    _require(div < VORTEX_DIV, f"div_after {div:.3e}", out)
    print(f"vortex-3d: OK (KE {ke0:.4e} -> {ke1:.4e}, div_after={div:.2e})")
    return out


def vortex_3d(full=False, device=None, **over):
    """inputs_vortextube_3d: prob_type 4, a fully periodic vortex tube,
    single level (reference initdata.f90:276-306). Invariants: constant
    density stays constant, kinetic energy does not grow (viscosity and the
    projection dissipate slightly), divergence at tolerance."""
    v = Varden(_load("vortex-3d", full, **over), device=device)
    st0 = v.initialize()
    ke0 = float((_host(st0.u) ** 2).sum())
    return _vortex_check(v, ke0, v.run(st0))


RUNNERS = {
    "bubble-2d": bubble_2d,
    "bubble-3d": bubble_3d,
    "bubble-restart": bubble_restart,
    "advect-2d": advect_2d,
    "advect-3d": advect_3d,
    "rt-2d": rt_2d,
    "rt-3d": rt_3d,
    "vortex-3d": vortex_3d,
}


def run_workload(name, full=False, device=None, **over):
    """Run one workload with its checks; returns the checks' numbers with
    the wall seconds (``wall_s``, the card synchronised), ``steps_run`` and
    ``s_per_step``. A failed check raises CheckFailed with these numbers in
    its ``numbers``."""
    def timed(out):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        out.setdefault("steps_run", out.get("steps", 0))
        out["s_per_step"] = out["wall_s"] / max(out["steps_run"], 1)
        return out

    t0 = time.perf_counter()
    try:
        return timed(RUNNERS[name](full=full, device=device, **over))
    except CheckFailed as e:
        timed(e.numbers)
        raise


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m varden_tpu_torch.regression",
        description="the reference's regression workloads on the port")
    ap.add_argument("workload", nargs="?", default="all",
                    choices=["all"] + list(RUNNERS))
    ap.add_argument("--full", action="store_true",
                    help="run the shipped inputs files unchanged")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch path (default: the card)")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None,
                    help="override the files' float64")
    args = ap.parse_args(argv)
    over = {} if args.dtype is None else {"dtype": args.dtype}
    names = list(RUNNERS) if args.workload == "all" else [args.workload]
    mode = "full" if args.full else "quick"
    failed = []
    for name in names:
        print(f"=== {name} ({WORKLOADS[name][0]}, {mode}) ===", flush=True)
        try:
            out = run_workload(name, args.full, args.device, **over)
        except CheckFailed as e:
            print(f"FAILED {name}: {e}; {e.numbers}", flush=True)
            failed.append(name)
            out = e.numbers
        dev = torch.device(args.device or "cuda")
        where = ("the CPU" if dev.type == "cpu"
                 else torch.cuda.get_device_name(dev))
        print(f"  {name}: {out['wall_s']:.3f} s wall, {out['steps_run']} "
              f"steps, {out['s_per_step']:.4f} s/step on {where}", flush=True)
    if failed:
        print(f"FAILED: {', '.join(failed)}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
