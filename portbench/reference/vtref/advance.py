"""One full single-level timestep (counterpart of varden_tpu.advance):
the reference's advance_timestep call stack (src/advance_timestep.f90:
26-170) — premac (src/advance_premac.f90:17-61), MAC projection,
scalar_advance (src/scalar_advance.f90:17-173), make_at_halftime,
velocity_advance (src/velocity_advance.f90:17-142) and the nodal projection.

dm=2 and dm=3, inviscid or viscous and diffusive (Crank-Nicolson or
backward Euler). Both Godunov phases run through the kernels of
ops/cuda_godunov.py: fused with the update in 3-D, followed by the plain
basic.update in 2-D, as in varden_tpu. With use_godunov_debug they run the
full-array oracle of ops/godunov_ref.py instead, each followed by
basic.update (in 3-D the update_3d kernel), as varden_tpu routes that
flag. The projections, the viscous and diffusive solves and the explicit
Laplacians run through the solvers, whose modules say which of their
passes are kernels of ops/cuda_kernels.py.

The parts of a step are named torch.profiler ranges (RANGES), so that a
profile of a step gives host and device time by part.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.profiler import record_function

from . import projection
from .bc import grow_mac
from .ops import basic, cuda_godunov, godunov_ref
from .parallel import halo
from .solvers import mg
from .state import Sim, State


RANGES = ("step::velpred", "step::macproject", "step::scalar_advance",
          "step::velocity_advance", "step::visc_solve", "step::hgproject")


def embed_faces(sim: Sim, umac, ng: int):
    """Embed interior MAC components into ghost-padded cell-aligned tensors
    (face i at padded index ng+i) with one valid tangential ghost layer —
    the single-level analogue of create_umac_grown/fill_boundary
    (reference macproject.f90:107-120)."""
    dm, n = sim.dm, sim.n_cell
    grown = grow_mac(umac, 1, sim.pmask, dec=sim.dec)
    out = []
    for d in range(dm):
        arr = sim.zeros(tuple(s + 2 * ng for s in n))
        sl = tuple(slice(ng, ng + n[t] + 1) if t == d
                   else slice(ng - 1, ng + n[t] + 1) for t in range(dm))
        arr[sl] = grown[d]
        out.append(arr)
    return tuple(out)


def lap_velocity(sim: Sim, u: torch.Tensor) -> torch.Tensor:
    """lap(u) per component with its elliptic BCs: one batched pass when
    all components share them (e.g. no-slip walls)."""
    bcs = [projection.comp_bc(sim, d) for d in range(sim.dm)]
    if all(b == bcs[0] for b in bcs[1:]):
        ell_bc, bvals = bcs[0]
        return mg.laplacian(u, sim.n_cell, sim.dx, ell_bc, bvals,
                            dec=sim.dec)
    return torch.stack([projection.get_explicit_diffusive_term(sim, u[d], d)
                        for d in range(sim.dm)])


def lap_tracers(sim: Sim, s: torch.Tensor) -> torch.Tensor:
    """lap of each tracer; zero for the density (comp 0)."""
    out = [torch.zeros_like(s[0])]
    for i in range(1, s.shape[0]):
        out.append(projection.get_explicit_diffusive_term(sim, s[i],
                                                          sim.scal_comp(i)))
    return torch.stack(out)


def _warm(hints, cur_key, prev_key, dec=None):
    """Warm start: linear time-extrapolation once two consecutive past
    solutions exist (pressure-like fields evolve smoothly)."""
    if hints is None:
        return None
    cur, prev = hints.get(cur_key), hints.get(prev_key)
    if cur is not None and prev is not None:
        delta = cur - prev
        ok = mg._gmax(delta, dec) < 0.5 * mg._gmax(cur, dec)
        return torch.where(ok, cur + delta, cur)
    return cur


def _level_max(sim: Sim, x):
    """max|x| over the whole level where the run is decomposed (the
    Godunov kernels' tie epsilon is formed from it), else None: the
    kernels form it from their own input."""
    return None if sim.dec is None else mg._gmax(x, sim.dec)


def _level_extremes(sim: Sim, x, dim=None):
    """(min, max) of x over the whole level (per leading index with dim)."""
    lo = x.min() if dim is None else x.min(dim=dim).values
    hi = x.max() if dim is None else x.max(dim=dim).values
    if sim.dec is None:
        return lo, hi
    return halo.all_min(lo), halo.all_max(hi)


def _mkflux_update(sim: Sim, sold, s_pad, umac, mac_pads, force, fupd, dt,
                   adv_bc, is_vel, is_cons, umax=None, slopes=None):
    """Godunov edge states and the conservative/convective update of the
    components of ``sold``: one fused kernel in 3-D; in 2-D the edge-state
    kernel and then basic.update; with use_godunov_debug the oracle's edge
    states (``slopes``: the velocity's, from the predictor) and then
    basic.update. mac_rhs is None (zero) throughout. ``umax``: the level's
    max|umac| on a decomposed run."""
    cfg = sim.cfg
    tail = (dt, sim.dx, sim.phys_bc, adv_bc, sim.ng, sim.n_cell, is_vel,
            is_cons, cfg.slope_order, cfg.use_minion)
    if cfg.use_godunov_debug:
        if sim.dm == 3:
            sedge, sflux = godunov_ref.mkflux_3d(s_pad, mac_pads, force, None,
                                                 *tail, slopes=slopes,
                                                 umax=umax)
        else:
            ex, ey, fx, fy = godunov_ref.mkflux_2d(
                s_pad, mac_pads[0], mac_pads[1], force, None, *tail,
                umax=umax)
            sedge, sflux = (ex, ey), (fx, fy)
        return basic.update(sold, umac, sedge, sflux, fupd, dt, sim.dx,
                            is_cons)
    if sim.dm == 3:
        return cuda_godunov.mkflux_update_3d_fused(s_pad, mac_pads, force,
                                                   fupd, None, *tail,
                                                   umax=umax)
    ex, ey, fx, fy = cuda_godunov.mkflux_2d_fused(
        s_pad, mac_pads[0], mac_pads[1], force, None, *tail, umax=umax)
    return basic.update(sold, umac, (ex, ey), (fx, fy), fupd, dt, sim.dx,
                        is_cons)


def _velpred(sim: Sim, u_pad, vf_pad, dt, umax=None):
    """The Godunov MAC prediction: kernel 1 (3-D) or 9 (2-D), or with
    use_godunov_debug the oracle. Returns (umac, the oracle's velocity
    slopes in 3-D or None)."""
    cfg = sim.cfg
    args = (u_pad, vf_pad, dt, sim.dx, sim.phys_bc,
            [sim.adv_bc[d] for d in range(sim.dm)], sim.ng, sim.n_cell,
            cfg.slope_order, cfg.use_minion)
    if not cfg.use_godunov_debug:
        velpred = (cuda_godunov.velpred_2d_fused if sim.dm == 2
                   else cuda_godunov.velpred_3d_fused)
        return velpred(*args, umax=umax), None
    if sim.dm == 2:
        return godunov_ref.velpred_2d(*args, umax=umax), None
    slopes = godunov_ref.vel_slopes_3d(u_pad, args[5], sim.ng, sim.n_cell,
                                       cfg.slope_order)
    return godunov_ref.velpred_3d(*args, slopes=slopes, umax=umax), slopes


def advance_timestep(sim: Sim, state: State, dt: float, proj_type: int,
                     hints: Dict = None
                     ) -> Tuple[State, Dict[str, torch.Tensor]]:
    """One full timestep. ``hints`` optionally carries the previous step's
    projection solutions ({'phi_mac', 'phi_mac_prev', 'phi_hg',
    'phi_hg_prev'}) to warm-start the elliptic solves; the new ones are
    returned in the diag dict."""
    cfg = sim.cfg
    dm, ng = sim.dm, sim.ng
    uold, sold, gp, p = state.u, state.s, state.gp, state.p
    adv_bc_vel = [sim.adv_bc[d] for d in range(dm)]
    adv_bc_scal = [sim.adv_bc[sim.scal_comp(i)] for i in range(sim.nscal)]
    # mac_rhs is identically zero in this application (no divu sources):
    # it is passed as None throughout, never allocated

    # ---- explicit viscous term at t^n (advance_timestep.f90:85-93)
    lapu = lap_velocity(sim, uold) if cfg.visc_coef > 0.0 else None

    # ---- premac: cell force then Godunov MAC prediction
    vel_force = basic.mkvelforce(cfg.ext_force, sold, gp, lapu,
                                 cfg.visc_coef, 1.0, cfg.boussinesq)
    u_pad = sim.fill_vel(uold)
    vf_pad = sim.fill_extrap(vel_force, ng)
    with record_function("step::velpred"):
        umac, u_slopes = _velpred(sim, u_pad, vf_pad, dt,
                                  _level_max(sim, uold))

    # ---- MAC projection
    with record_function("step::macproject"):
        (umac, div_b, div_a, phi_mac, mac_rn,
         mac_ratio) = projection.macproject(
            sim, umac, sold[0], None,
            phi0=_warm(hints, "phi_mac", "phi_mac_prev", sim.dec))
    mac_max = (None if sim.dec is None else
               _level_max(sim, torch.stack([f.abs().max() for f in umac])))

    # ---- scalar advance: with diff_coef=0 both scalar forces are zero
    # (mkscalforce), so force and fupd are None
    laps = sf_pad = scal_force_half = None
    if cfg.diff_coef > 0.0:
        laps = lap_tracers(sim, sold)
        sf_pad = sim.fill_extrap(
            basic.mkscalforce(None, laps, cfg.diff_coef, 1.0), ng)
        scal_force_half = basic.mkscalforce(None, laps, cfg.diff_coef, 0.0)
    is_cons = [True] + [False] * (sim.nscal - 1)
    s_pad = sim.fill_scal(sold)
    mac_pads = embed_faces(sim, umac, ng)
    with record_function("step::scalar_advance"):
        snew = _mkflux_update(sim, sold, s_pad, umac, mac_pads, sf_pad,
                              scal_force_half, dt, adv_bc_scal, False,
                              is_cons, mac_max)
    del s_pad, sf_pad, scal_force_half
    if cfg.diff_coef > 0.0:
        visc_mu = (0.5 * dt * cfg.diff_coef if cfg.diffusion_type == 1
                   else dt * cfg.diff_coef)
        snew = projection.diff_scalar_solve(sim, snew, laps, visc_mu,
                                            cfg.diffusion_type)

    # ---- half-time density
    rhohalf = basic.make_at_halftime(sold[0], snew[0])

    # ---- velocity advance: t^n force for the edge states, half-time
    # force (rhohalf, visc_fac=0; velocity_advance.f90:86) for the update
    vel_force_half = basic.mkvelforce_half(
        cfg.ext_force, rhohalf, sold[1] if cfg.boussinesq == 1 else None,
        gp, cfg.boussinesq)
    with record_function("step::velocity_advance"):
        unew = _mkflux_update(sim, uold, u_pad, umac, mac_pads, vf_pad,
                              vel_force_half, dt, adv_bc_vel, True,
                              [False] * dm, mac_max, u_slopes)
    del u_pad, vf_pad, mac_pads, u_slopes
    if cfg.visc_coef > 0.0:
        # backward Euler drops the explicit viscous term, Crank-Nicolson
        # keeps half of it (advance_timestep.f90:116-120)
        visc_mu = (0.5 * dt * cfg.visc_coef if cfg.diffusion_type == 1
                   else dt * cfg.visc_coef)
        with record_function("step::visc_solve"):
            unew, (visc_rn, visc_cycles, visc_ratio) = projection.visc_solve(
                sim, unew, lapu, rhohalf, None, visc_mu, cfg.diffusion_type,
                return_info=True)

    # ---- nodal projection
    diag = {}
    if cfg.visc_coef > 0.0:
        # V-cycles the viscous solve took after its smoothing sweeps (0: the
        # sweeps alone settled it), and its residual over its tolerance
        diag.update({"visc_resnorm": visc_rn, "visc_cycles": visc_cycles,
                     "visc_ratio": visc_ratio})
    if cfg.verbose >= 1:
        diag["u_pre_min"], diag["u_pre_max"] = _level_extremes(
            sim, unew.reshape(dm, -1), dim=1)
    with record_function("step::hgproject"):
        unew, p, gp, phi_hg, hg_rn, hg_ratio = projection.hgproject(
            sim, proj_type, unew, uold, rhohalf, p, gp, dt,
            phi0=_warm(hints, "phi_hg", "phi_hg_prev", sim.dec))
    if cfg.verbose >= 1:
        diag["u_post_min"], diag["u_post_max"] = _level_extremes(
            sim, unew.reshape(dm, -1), dim=1)

    smin, smax = _level_extremes(sim, snew[0])
    diag.update({"div_before": div_b, "div_after": div_a,
                 "smin": smin, "smax": smax,
                 "umax": mg._gmax(unew, sim.dec),
                 "mac_resnorm": mac_rn, "hg_resnorm": hg_rn,
                 "mac_ratio": mac_ratio, "hg_ratio": hg_ratio,
                 "phi_mac": phi_mac, "phi_hg": phi_hg})
    return State(u=unew, s=snew, gp=gp, p=p), diag


def estdt(sim: Sim, state: State, dtold: float) -> float:
    return basic.estdt(state.u, state.s[0], state.gp, sim.cfg.ext_force,
                       sim.dx, dtold, sim.cfg.cflfac, sim.cfg.max_dt_growth,
                       level_max=None if sim.dec is None else halo.all_max)
