"""Multi-level (AMR) advance_timestep (counterpart of
varden_tpu.amr.advance_ml).

The reference's non-subcycled multilevel step (advance_timestep.f90 with
nlevs > 1): every phase runs on all levels with coarse-fine coupling —
fillpatch ghosts, create_umac_grown, ml_edge_restriction, composite MAC and
nodal projections, conservative flux synchronization, ml_restrict_and_fill.
All levels advance with the same dt (Docs/DesignDocument.tex:54-55).

The per-level Godunov work runs through the kernels of ops/cuda_godunov.py,
as varden_tpu runs its Pallas kernels per level. In 3-D the scalar and the
velocity advance run the fused mkflux + update kernel on every level; for
the scalars it also emits the conservative fluxes that the flux registers
synchronise (its flux_comps option, as in varden_tpu); with
use_godunov_debug a 3-D level takes varden_tpu's unfused route instead:
the edge-state kernel mkflux_3d_fused, whose fluxes the registers read,
then the update_3d kernel. In 2-D the edge kernel is mkflux_2d_fused
followed by the plain update, as in varden_tpu, with or without the flag.
The parts of
the step are the spans of the single-level step (profiling.span,
advance.RANGES).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .. import profiling, projection
from .. import bc as bc_mod
from ..ops import basic, cuda_godunov
from ..parallel import halo
from ..parallel import mesh as pmesh
from ..solvers import mg, nodal
from ..state import State
from . import solve as amr_solve
from .fill import (MLGeom, level_max, level_min, pad_ml, pad_ml_multi,
                   put_into_parent)
from .hierarchy import _interleave, _sl, restrict_cells, restrict_faces
from .solve import pad_phi

# The velocity components share the Helmholtz operator of the viscous
# solve; when their elliptic BCs agree, one batched composite solve replaces
# dm sequential ones on hierarchies up to this many cells (above it the
# (dm, *n) solve stacks triple the phase's memory).
BATCH_MAX_CELLS = 5e7


# ---------------------------------------------------------------------------
# MAC helpers
# ---------------------------------------------------------------------------

def _faces(d, dm):
    return tuple(int(t == d) for t in range(dm))


def edge_restrict_mac(geom: MLGeom, umac_l):
    """Average fine faces onto coincident coarse faces (ml_edge_restriction,
    velpred.f90:115-119, macproject.f90:497-501). Children fold into their
    parents in reverse node order (fine to coarse). The parents' face
    tensors are replaced by updated copies."""
    out = [list(u) for u in umac_l]
    copied = set()
    for c in range(geom.nlev - 1, 0, -1):
        p = geom.parent[c]
        for d in range(geom.dm):
            if (p, d) not in copied:
                out[p][d] = out[p][d].clone()
                copied.add((p, d))
            put_into_parent(geom, c, out[p][d],
                            restrict_faces(out[c][d], d, geom.dm),
                            _faces(d, geom.dm))
    return [tuple(u) for u in out]


def embed_faces_block(geom: MLGeom, umac, ng: int):
    """advance.embed_faces on the rank's block of level 0: interior MAC
    components in ghost-padded cell-aligned tensors with one valid
    tangential ghost layer (the neighbours' faces on internal faces)."""
    dm, n = geom.dm, geom.bn(0)
    grown = bc_mod.grow_mac(umac, 1, geom.bpmask(0), dec=geom.decs[0])
    out = []
    for d in range(dm):
        arr = umac[0].new_zeros(tuple(s + 2 * ng for s in n))
        sl = tuple(slice(ng, ng + n[t] + 1) if t == d
                   else slice(ng - 1, ng + n[t] + 1) for t in range(dm))
        arr[sl] = grown[d]
        out.append(arr)
    return tuple(out)


def _mac_window(geom: MLGeom, lev, r, d):
    """The parent face window (lo, hi), parent-patch index, from which
    grow_mac_ml interpolates rank r's block of ``lev`` (axis-d faces): the
    coarse faces and cells its fine faces and ghost ring read, one more on
    each side, cut to the parent."""
    dec = geom.decs[lev]
    spec, pspec = geom.specs[lev], geom.specs[geom.parent[lev]]
    blo = spec.lo if dec is None else dec.of_rank(r).glo
    n = geom.bn(lev)
    lo, hi = [], []
    for t in range(geom.dm):
        g = 0 if t == d else 1
        start = blo[t] - 2 * pspec.lo[t] - g
        stop = start + n[t] + 2 * g + (1 if t == d else 0)
        lo.append(max(start // 2 - 1, 0))
        hi.append(min((stop - 1) // 2 + 2,
                      pspec.n[t] + (1 if t == d else 0)))
    return tuple(lo), tuple(hi)


def grow_mac_ml(geom: MLGeom, umac_l, lev: int, ng: int):
    """Cell-aligned padded MAC tensors with one valid tangential ghost
    layer.

    Level 0 wraps / extrapolates (advance.embed_faces); finer levels take
    their coarse-fine tangential ghosts from the parent's MAC field, the
    two-stage linear interpolation of create_umac_grown.f90 (consumed at
    velpred.f90:102-106): linear in the normal direction (even fine faces
    coincide with coarse faces, odd ones average the bracketing pair) and
    linear tangentially (fine = 3/4 c[i] + 1/4 c[i -+ 1]). Under a mesh the
    parent's faces come from the window _mac_window fetches."""
    dm = geom.dm
    if lev == 0:
        return embed_faces_block(geom, umac_l[0], ng)
    par = geom.parent[lev]
    spec, pspec = geom.specs[lev], geom.specs[par]
    blo, n = geom.blo(lev), geom.bn(lev)
    out = []
    for d in range(dm):
        wlo, _whi = _mac_window(geom, lev, pmesh.rank(), d)
        cu = halo.fetch(umac_l[par][d], geom.decs[par],
                        lambda r, _d=d: _mac_window(geom, lev, r, _d), kind=d)
        arr = cu.new_zeros(tuple(s + 2 * ng for s in n))
        up = cu
        for t in range(dm):
            if t == d:
                mid = 0.5 * (up[_sl(up.ndim, t, slice(0, -1))]
                             + up[_sl(up.ndim, t, slice(1, None))])
                z = torch.zeros_like(up[_sl(up.ndim, t, slice(0, 1))])
                up = _interleave(up, torch.cat([mid, z], dim=t), t)
                up = up[_sl(up.ndim, t, slice(0, 2 * cu.shape[t] - 1))]
            else:
                first = up[_sl(up.ndim, t, slice(0, 1))]
                last = up[_sl(up.ndim, t, slice(-1, None))]
                prv = torch.cat([first, up[_sl(up.ndim, t, slice(0, -1))]],
                                dim=t)
                nxt = torch.cat([up[_sl(up.ndim, t, slice(1, None))], last],
                                dim=t)
                up = _interleave(0.75 * up + 0.25 * prv,
                                 0.75 * up + 0.25 * nxt, t)
        # up: fine-index face field with origin 2*(pspec.lo + wlo); clip
        # the source window where the ghost ring would leave the parent's
        # face range (a box corner on the domain boundary: those ghost
        # faces feed only edge states that the physical-boundary logic
        # overwrites)
        sl, dst = [], []
        for t in range(dm):
            g = 0 if t == d else 1
            start = blo[t] - 2 * pspec.lo[t] - g
            stop = start + n[t] + 2 * g + (1 if t == d else 0)
            full = 2 * pspec.n[t] + (1 if t == d else 0)
            s_lo, s_hi = max(start, 0), min(stop, full)
            sl.append(slice(s_lo - 2 * wlo[t], s_hi - 2 * wlo[t]))
            d_lo = ng - g + (s_lo - start)
            dst.append(slice(d_lo, d_lo + (s_hi - s_lo)))
        arr[tuple(dst)] = up[tuple(sl)]
        del up
        # the faces, with the neighbour blocks' in the tangential ghost
        # layer of an internal face (not across a periodic seam, where the
        # whole patch has the parent's too)
        f, lo_t = umac_l[lev][d], [0] * dm
        dec = geom.decs[lev]
        for t in range(dm):
            if t == d or dec is None:
                continue
            lo, hi = halo.exchange(f, dec, t, 1, 1)
            lo = None if dec.seam(t, 0) else lo
            hi = None if dec.seam(t, 1) else hi
            lo_t[t] = 0 if lo is None else 1
            f = torch.cat([x for x in (lo, f, hi) if x is not None], dim=t)
        arr[tuple(slice(ng - lo_t[t], ng - lo_t[t] + f.shape[t])
                  for t in range(dm))] = f
        out.append(arr)
    return tuple(out)


# ---------------------------------------------------------------------------
# composite projections
# ---------------------------------------------------------------------------

def macproject_ml(geom: MLGeom, umac_l, rho_l, phi0_l=None):
    """Composite MAC projection (reference macproject.f90:20-133 over the
    level hierarchy). phi0_l warm-starts the composite solve. rho_l[l] is
    the level's (nscal, *n) scalar state (component 0 is read)."""
    sim = geom.sim
    dm, nlev = geom.dm, geom.nlev
    rel_eps = sim.eps(1.0e-10)
    beta_l, rhs_l = [], []
    rho_arrs = [s[0] for s in rho_l]
    for l in range(nlev):
        rho_pad = pad_ml(geom, rho_arrs, sim.scal_comp(0), l, 1)
        beta_l.append(tuple(projection._face_diff(
            rho_pad, d, dm, lambda h, lo: 2.0 / (h + lo)) for d in range(dm)))
        rhs_l.append(-basic.mac_div(umac_l[l], geom.dx(l)))
    div_before = amr_solve._max_abs(geom, rhs_l)
    aco_l = [torch.zeros(geom.bn(l), dtype=sim.dtype, device=sim.device)
             for l in range(nlev)]
    phis, (_rn, mac_outer, mac_ratio) = amr_solve.composite_cc_solve(
        geom, sim.press_comp, rhs_l, aco_l, beta_l, 0.0, phi0_l=phi0_l,
        rel_eps=rel_eps, return_info=True)
    del rhs_l, aco_l

    ell0 = [tuple(sim.ell_bc[sim.press_comp][d]) for d in range(dm)]
    new_umac = []
    for l in range(nlev):
        pad = pad_phi(geom, l, phis, ell0, [[0.0, 0.0]] * dm, ng=1)
        new_umac.append(tuple(
            umac_l[l][d] - beta_l[l][d] * projection._face_diff(
                pad, d, dm, lambda h, lo, _h=geom.dx(l)[d]: (h - lo) / _h)
            for d in range(dm)))
    new_umac = edge_restrict_mac(geom, new_umac)
    div_after = amr_solve._max_abs(geom, [basic.mac_div(new_umac[l],
                                                        geom.dx(l))
                                          for l in range(nlev)])
    return new_umac, div_before, div_after, phis, mac_ratio, mac_outer


def hgproject_ml(geom: MLGeom, proj_type, unew_l, uold_l, rhohalf_l, p_l,
                 gp_l, dt, phi0_l=None):
    """Composite nodal projection (reference hgproject.f90 over the level
    hierarchy). phi0_l warm-starts the composite nodal solve. Returns
    (u_l, p_l, gp_l, phi_l, ratio, outer cycles)."""
    sim = geom.sim
    dm, nlev = geom.dm, geom.nlev
    rel_eps = sim.eps(1.0e-10)
    pmask_l = [geom.bpmask(l) for l in range(nlev)]
    vel_l, sigma_l, inflow_l = [], [], []
    base_inflow = projection._inflow_pad(sim)
    for l in range(nlev):
        if proj_type in (projection.INITIAL_PROJECTION,
                         projection.DIVU_ITERS):
            vel = unew_l[l]
        elif proj_type == projection.PRESSURE_ITERS:
            vel = (unew_l[l] - uold_l[l]) / dt
        else:
            vel = unew_l[l] + dt * gp_l[l] / rhohalf_l[l]
        vel_l.append(vel)
        sigma_l.append(1.0 / rhohalf_l[l])
        if l == 0:
            inflow_l.append(base_inflow)
        else:
            # a fine level whose box touches an INLET domain side needs the
            # same EXT_DIR ghost velocity in its weak divergence; coarse-fine
            # sides stay zero (those rows are interface-masked anyway)
            def inflow(c, d, side, _l=l):
                if geom.side_kind(_l, d, side) == "phys":
                    return base_inflow(c, d, side)
                return 0.0
            inflow_l.append(inflow)

    phis, (_rn, hg_outer, hg_ratio) = amr_solve.composite_nodal_solve(
        geom, sigma_l, vel_l, inflow_pad_l=inflow_l, phi0_l=phi0_l,
        rel_eps=rel_eps, return_info=True)
    del sigma_l

    new_u, new_p, new_gp = [], [], []
    for l in range(nlev):
        gphi = nodal.cell_grad(phis[l], geom.dx(l), pmask_l[l], dm)
        vel = vel_l[l] - gphi / rhohalf_l[l]
        if proj_type == projection.PRESSURE_ITERS:
            u = uold_l[l] + dt * vel
        else:
            u = vel
        if proj_type in (projection.INITIAL_PROJECTION,
                         projection.DIVU_ITERS):
            gp = torch.zeros_like(gp_l[l])
            p = torch.zeros_like(p_l[l])
        elif proj_type == projection.PRESSURE_ITERS:
            gp = gp_l[l] + gphi
            p = p_l[l] + phis[l]
        else:
            gp = gphi / dt
            p = phis[l] / dt
        new_u.append(u)
        new_p.append(p)
        new_gp.append(gp)
    del vel_l
    new_u = restrict_and_sync(geom, new_u)
    new_gp = restrict_and_sync(geom, new_gp)
    return new_u, new_p, new_gp, phis, hg_ratio, hg_outer


def restrict_and_sync(geom: MLGeom, arrs_l):
    """Average fine data down onto covered coarse cells (the restriction
    half of ml_restrict_and_fill), children into their parents in reverse
    node order. Parents are replaced by updated copies."""
    out = list(arrs_l)
    copied = set()
    for c in range(geom.nlev - 1, 0, -1):
        p = geom.parent[c]
        if p not in copied:
            out[p] = out[p].clone()
            copied.add(p)
        put_into_parent(geom, c, out[p], restrict_cells(out[c], geom.dm))
    return out


def flux_sync(geom: MLGeom, flux_l, is_cons):
    """Replace coarse conservative fluxes on faces coincident with fine
    faces by the averaged fine fluxes (ml_edge_restriction_c,
    mkflux.f90:137-146). flux_l[l][d]: (nc, faces)."""
    dm = geom.dm
    out = [list(f) for f in flux_l]
    copied = set()
    cons = [c for c in range(len(is_cons)) if is_cons[c]]
    for ci in range(geom.nlev - 1, 0, -1):
        p = geom.parent[ci]
        for d in range(dm):
            if (p, d) not in copied:
                out[p][d] = out[p][d].clone()
                copied.add((p, d))
            rf = restrict_faces(out[ci][d], d, dm)
            if len(cons) == len(is_cons):
                put_into_parent(geom, ci, out[p][d], rf, _faces(d, dm))
            else:
                for c in cons:
                    put_into_parent(geom, ci, out[p][d][c], rf[c],
                                    _faces(d, dm))
    return [tuple(f) for f in out]


# ---------------------------------------------------------------------------
# the multilevel step
# ---------------------------------------------------------------------------

def _warm(geom, hints, cur_key, prev_key):
    """Per-node warm start: linear time-extrapolation once two consecutive
    past solutions exist (see advance._warm), else the last solution."""
    if hints is None or hints.get(cur_key) is None:
        return None
    cur, prev = hints[cur_key], hints.get(prev_key)
    if prev is None:
        return cur
    out = []
    for c, pv in zip(cur, prev):
        delta = c - pv
        ok = level_max(geom, delta.abs().max()) < \
            0.5 * level_max(geom, c.abs().max())
        out.append(torch.where(ok, c + delta, c))
    return out


def _lap_level(geom: MLGeom, l, arrs, ell, bv):
    """lap of one variable on level l with its solver-BC / coarse-fine
    ghosts (explicit_diffusive_term over the hierarchy)."""
    sim = geom.sim
    pad = pad_phi(geom, l, arrs, ell, bv, ng=1)
    zero = torch.zeros(geom.bn(l), dtype=sim.dtype, device=sim.device)
    return -mg.apply_padded(pad, zero, (1.0,) * geom.dm, 0.0, geom.dx(l),
                            geom.dm)


def _mkflux_update_level(geom: MLGeom, l, old, s_pad, umac, mac_pads, force,
                         fupd, dt, comps, is_vel, is_cons, flux_comps=(),
                         umax=None):
    """Godunov edge states and the update of one level's components, and
    the conservative fluxes of the components ``flux_comps`` lists (the
    flux registers read them): in 3-D one pass of the fused kernel, which
    emits the listed fluxes beside the update as varden_tpu's does, or with
    use_godunov_debug varden_tpu's unfused route, the edge kernel (its
    sflux the listed fluxes) and then basic.update (the update_3d kernel);
    in 2-D the edge kernel and the plain update. ``comps``: the components'
    global indices (their adv_bc). Returns (new, fluxes or None)."""
    sim = geom.sim
    cfg = sim.cfg
    tail = (dt, geom.dx(l), geom.phys_bc_block(l),
            geom.adv_bc_block(l, comps), sim.ng,
            geom.bn(l), is_vel, is_cons, cfg.slope_order, cfg.use_minion)
    if geom.dm == 3 and cfg.use_godunov_debug:
        sedge, sflux = cuda_godunov.mkflux_3d_fused(
            s_pad, mac_pads, force, None, *tail, umax=umax)
        new = basic.update(old, umac, sedge, sflux, fupd, dt, geom.dx(l),
                           is_cons)
        if not flux_comps:
            return new, None
        return new, tuple(f[list(flux_comps)] for f in sflux)
    if geom.dm == 3:
        out = cuda_godunov.mkflux_update_3d_fused(
            s_pad, mac_pads, force, fupd, None, *tail, flux_comps=flux_comps,
            umax=umax)
        return out if flux_comps else (out, None)
    ex, ey, fx, fy = cuda_godunov.mkflux_2d_fused(
        s_pad, mac_pads[0], mac_pads[1], force, None, *tail, umax=umax)
    new = basic.update(old, umac, (ex, ey), (fx, fy), fupd, dt, geom.dx(l),
                       is_cons)
    if not flux_comps:
        return new, None
    return new, tuple(f[list(flux_comps)] for f in (fx, fy))


def ml_advance(geom: MLGeom, states: List[State], dt, proj_type: int,
               hints: Dict = None) -> Tuple[List[State], Dict]:
    """One multilevel timestep. ``hints`` optionally carries per-level
    warm starts ({'phi_mac', 'phi_hg'} and, when kept, their '_prev'
    partners); the new solutions are returned in the diag dict."""
    sim = geom.sim
    cfg = sim.cfg
    dm, nlev, ng = geom.dm, geom.nlev, sim.ng
    vel_comps = list(range(dm))
    scal_comps = [sim.scal_comp(i) for i in range(sim.nscal)]
    u_l = [st.u for st in states]
    s_l = [st.s for st in states]
    gp_l = [st.gp for st in states]
    p_l = [st.p for st in states]
    ell_bc_vel = [[tuple(sim.ell_bc[d][t]) for t in range(dm)]
                  for d in range(dm)]
    bv_vel = [[[sim.bvals[d][t][s2] for s2 in range(2)] for t in range(dm)]
              for d in range(dm)]

    # explicit viscous term per level (coarse-fine ghosts via the solver pad)
    lapu_l = None
    if cfg.visc_coef > 0.0:
        lapu_l = [torch.stack([_lap_level(geom, l, [u[d] for u in u_l],
                                          ell_bc_vel[d], bv_vel[d])
                               for d in range(dm)]) for l in range(nlev)]

    def vel_pads():
        """The t^n velocity and force pads of every level. Built for the
        predictor and again for the velocity advance, so that the first set
        dies before the MAC solve."""
        vf_l = [basic.mkvelforce(cfg.ext_force, s_l[l], gp_l[l],
                                 None if lapu_l is None else lapu_l[l],
                                 cfg.visc_coef, 1.0, cfg.boussinesq)
                for l in range(nlev)]
        return ([pad_ml_multi(geom, u_l, vel_comps, l, ng)
                 for l in range(nlev)],
                [pad_ml_multi(geom, vf_l, [sim.extrap_comp] * dm, l, ng)
                 for l in range(nlev)])

    # ---- premac: Godunov MAC prediction per level
    velpred = (cuda_godunov.velpred_2d_fused if dm == 2
               else cuda_godunov.velpred_3d_fused)
    with profiling.span("step::velpred"):
        u_pads, vf_pads = vel_pads()
        umac_l = [velpred(u_pads[l], vf_pads[l], dt, geom.dx(l),
                          geom.phys_bc_block(l),
                          geom.adv_bc_block(l, vel_comps), ng,
                          geom.bn(l), cfg.slope_order, cfg.use_minion,
                          umax=_block_max(geom, u_l[l]))
                  for l in range(nlev)]
        del u_pads, vf_pads
        umac_l = edge_restrict_mac(geom, umac_l)

    # ---- composite MAC projection
    with profiling.span("step::macproject"):
        umac_l, div_b, div_a, phi_mac_l, mac_ratio, mac_outer = \
            macproject_ml(geom, umac_l, s_l,
                          phi0_l=_warm(geom, hints, "phi_mac", "phi_mac_prev"))
        mac_pads_l = [grow_mac_ml(geom, umac_l, l, ng) for l in range(nlev)]
        mac_max_l = [_block_max(geom, torch.stack([f.abs().max()
                                                   for f in umac_l[l]]))
                     for l in range(nlev)]

    # ---- scalar advance with each level's own fluxes; the inter-level
    # conservative flux sync (ml_edge_restriction_c, mkflux.f90:137-146) is
    # then applied as the equivalent post-correction
    # snew += -dt div(F_synced - F_own), non-zero only next to children
    laps_l = None
    if cfg.diff_coef > 0.0:
        laps_l = []
        for l in range(nlev):
            comps = [torch.zeros(geom.bn(l), dtype=sim.dtype,
                                 device=sim.device)]
            for i in range(1, sim.nscal):
                ell, bv = projection.comp_bc(sim, sim.scal_comp(i))
                comps.append(_lap_level(geom, l, [s[i] for s in s_l], ell,
                                        bv))
            laps_l.append(torch.stack(comps))
    is_cons = [True] + [False] * (sim.nscal - 1)
    cons_idx = [i for i in range(sim.nscal) if is_cons[i]]
    need_flux = nlev > 1 and len(cons_idx) > 0
    snew_l, sflux_own_l = [], []
    # with diff_coef = 0 both scalar forces are zero (mkscalforce): None
    sf_l = (None if laps_l is None else
            [basic.mkscalforce(None, lp, cfg.diff_coef, 1.0) for lp in laps_l])
    with profiling.span("step::scalar_advance"):
        for l in range(nlev):
            sf_pad = sf_half = None
            if laps_l is not None:
                sf_pad = pad_ml_multi(geom, sf_l, [sim.extrap_comp] *
                                      sim.nscal, l, ng)
                sf_half = basic.mkscalforce(None, laps_l[l], cfg.diff_coef,
                                            0.0)
            s_pad = pad_ml_multi(geom, s_l, scal_comps, l, ng)
            snew, sflux = _mkflux_update_level(
                geom, l, s_l[l], s_pad, umac_l[l], mac_pads_l[l], sf_pad,
                sf_half, dt, scal_comps, False, is_cons,
                tuple(cons_idx) if need_flux else (), umax=mac_max_l[l])
            del s_pad, sf_pad, sf_half
            snew_l.append(snew)
            sflux_own_l.append(sflux)
            del sflux
        if need_flux:
            synced = flux_sync(geom, sflux_own_l, [True] * len(cons_idx))
            for l in range(nlev):
                if not geom.children[l]:
                    continue  # F_synced == F_own on childless nodes
                corr = sum(basic._fdiff(synced[l][d] - sflux_own_l[l][d], d,
                                        dm) / geom.dx(l)[d]
                           for d in range(dm))
                snew_l[l][cons_idx] += -dt * corr
            del synced
        del sflux_own_l, sf_l
        snew_l = restrict_and_sync(geom, snew_l)

    if cfg.diff_coef > 0.0:
        visc_mu = (0.5 * dt * cfg.diff_coef if cfg.diffusion_type == 1
                   else dt * cfg.diff_coef)
        for i in range(1, sim.nscal):
            comp = sim.scal_comp(i)
            _ell, bv = projection.comp_bc(sim, comp)
            rhs_l = []
            for l in range(nlev):
                rh = snew_l[l][i]
                if cfg.diffusion_type == 1:
                    rh = rh + visc_mu * laps_l[l][i]
                rhs_l.append(rh)
            phis, _ = amr_solve.composite_cc_solve(
                geom, comp, rhs_l,
                [torch.ones_like(r) for r in rhs_l], [(visc_mu,) * dm] * nlev,
                1.0, phi0_l=[s[i] for s in snew_l], bvals=bv,
                rel_eps=sim.eps(1.0e-12))
            snew_l = [s.clone() for s in snew_l]
            for l in range(nlev):
                snew_l[l][i] = phis[l]
        snew_l = restrict_and_sync(geom, snew_l)
    del laps_l

    # ---- half-time density
    rhohalf_l = [basic.make_at_halftime(s_l[l][0], snew_l[l][0])
                 for l in range(nlev)]

    # ---- velocity advance: no inter-level flux coupling (velocity is
    # convective), so the fused kernel runs per level. The t^n force and
    # pads are rebuilt from the live t^n fields.
    visc_cycles = []
    visc_ratio = 0.0
    with profiling.span("step::velocity_advance"):
        u_pads, vf_pads = vel_pads()
        unew_l = []
        for l in range(nlev):
            vfh = basic.mkvelforce_half(
                cfg.ext_force, rhohalf_l[l],
                s_l[l][1] if cfg.boussinesq == 1 else None, gp_l[l],
                cfg.boussinesq)
            unew, _ = _mkflux_update_level(
                geom, l, u_l[l], u_pads[l], umac_l[l], mac_pads_l[l],
                vf_pads[l], vfh, dt, vel_comps, True, [False] * dm,
                umax=mac_max_l[l])
            u_pads[l] = vf_pads[l] = None
            unew_l.append(unew)
        del u_pads, vf_pads, mac_pads_l
    if cfg.diffusion_type == 2 and lapu_l is not None:
        lapu_l = None  # backward Euler drops the explicit viscous term

    if cfg.visc_coef > 0.0:
        visc_mu = (0.5 * dt * cfg.visc_coef if cfg.diffusion_type == 1
                   else dt * cfg.visc_coef)
        beta = [(visc_mu,) * dm] * nlev  # constant coefficient: no faces
        with profiling.span("step::visc_solve"):
            ell_same = all(sim.ell_bc[d2] == sim.ell_bc[0]
                           for d2 in range(dm))
            if ell_same and geom.cells() <= BATCH_MAX_CELLS:
                # one batched composite solve; per-component boundary
                # values ride the leading batch axis
                rhs_l = []
                for l in range(nlev):
                    rh = unew_l[l] * rhohalf_l[l]
                    if lapu_l is not None:
                        rh = rh + visc_mu * lapu_l[l]
                    rhs_l.append(rh)
                bv_b = [[torch.tensor([bv_vel[c][t][s2] for c in range(dm)],
                                      dtype=sim.dtype, device=sim.device
                                      ).reshape((dm,) + (1,) * dm)
                         for s2 in range(2)] for t in range(dm)]
                unew_l, (_rn, outer, ratio) = amr_solve.composite_cc_solve(
                    geom, 0, rhs_l, rhohalf_l, beta, 1.0, phi0_l=unew_l,
                    bvals=bv_b, rel_eps=sim.eps(1.0e-12), return_info=True)
                del rhs_l
                visc_cycles.append(outer)
                visc_ratio = float(ratio)
            else:
                unew_l = [u.clone() for u in unew_l]
                for d in range(dm):
                    rhs_l = []
                    for l in range(nlev):
                        rh = unew_l[l][d] * rhohalf_l[l]
                        if lapu_l is not None:
                            rh = rh + visc_mu * lapu_l[l][d]
                        rhs_l.append(rh)
                    phis, (_rn, outer, ratio) = amr_solve.composite_cc_solve(
                        geom, d, rhs_l, rhohalf_l, beta, 1.0,
                        phi0_l=[u[d] for u in unew_l], bvals=bv_vel[d],
                        rel_eps=sim.eps(1.0e-12), return_info=True)
                    del rhs_l
                    for l in range(nlev):
                        unew_l[l][d] = phis[l]
                    del phis
                    visc_cycles.append(outer)
                    visc_ratio = max(visc_ratio, float(ratio))
            unew_l = restrict_and_sync(geom, unew_l)
    del lapu_l

    # ---- composite nodal projection
    with profiling.span("step::hgproject"):
        unew_l, p_l, gp_l, phi_hg_l, hg_ratio, hg_outer = hgproject_ml(
            geom, proj_type, unew_l, u_l, rhohalf_l, p_l, gp_l, dt,
            phi0_l=_warm(geom, hints, "phi_hg", "phi_hg_prev"))

    new_states = [State(u=unew_l[l], s=snew_l[l], gp=gp_l[l], p=p_l[l])
                  for l in range(nlev)]
    diag = {"div_before": div_b, "div_after": div_a,
            "smin": level_min(geom, snew_l[0][0].min()),
            "smax": level_max(geom, snew_l[0][0].max()),
            "umax": level_max(geom, unew_l[0].abs().max()),
            "mac_ratio": mac_ratio, "hg_ratio": hg_ratio,
            "mac_outer": mac_outer, "hg_outer": hg_outer,
            "phi_mac": phi_mac_l, "phi_hg": phi_hg_l}
    if cfg.visc_coef > 0.0:
        diag.update({"visc_outer": visc_cycles, "visc_ratio": visc_ratio})
    return new_states, diag


def _block_max(geom: MLGeom, x):
    """max|x| over a decomposed patch (the Godunov kernels' tie epsilon is
    formed from it), else None: the kernels form it from their input."""
    return None if geom.decs[0] is None else halo.all_max(x.abs().max())


def ml_estdt(geom: MLGeom, states, dtold) -> float:
    """The smallest of the levels' dt estimates (a host float); each
    level's maxima over all of its blocks where it is decomposed."""
    sim = geom.sim
    lmax = None if geom.decs[0] is None else halo.all_max
    return min(basic.estdt(states[l].u, states[l].s[0], states[l].gp,
                           sim.cfg.ext_force, geom.dx(l), dtold,
                           sim.cfg.cflfac, sim.cfg.max_dt_growth,
                           level_max=lmax)
               for l in range(geom.nlev))
