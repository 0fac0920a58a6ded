"""Composite (multi-level) elliptic solves (counterpart of
varden_tpu.amr.solve).

FBoxLib's ml_cc_solve / ml_nd_solve as consumed by the reference's
mac_multigrid / hg_multigrid wrappers: the coupled coarse/fine problem is
iterated with a recursive composite V-cycle, each outer cycle being

  * composite residuals folded fine -> coarse, with flux-register
    corrections at coarse-fine faces (the bndry_reg / fine_flx role,
    macproject.f90:522-609) and covered rows restricted from the child,
  * a downward correction pass: a V-cycle per level with homogeneous
    interface ghosts, then the correction's own defect and flux registers
    folded into the parent,
  * a full V-cycle on the coarsest level, and an upward pass that
    re-smooths each level with parent-interpolated interface ghosts,
  * covered coarse data slaved to the restriction of the fine solution.

The per-level V-cycles are the single-level solvers' (solvers/mg.py and
solvers/nodal.py), so in 3-D their sweeps run through the same kernels. The
outer loop that the JAX package runs as lax.while_loop is a Python loop
here, reading the composite residual norm on the host once per outer cycle.
Tensors are updated in place where the JAX code makes a functional copy;
inputs the caller owns (warm starts, coefficients) are copied first. As in
the single-level solvers, the stopping tolerance includes the dtype's
attainable floor (_stop_test), which only a float32 run reaches.
"""
from __future__ import annotations

import torch

from ..bc import BC_DIR, BC_NEU
from ..config import OUTLET
from ..ops import cuda_kernels as ck
from ..solvers import mg, nodal
from .fill import MLGeom
from .hierarchy import _sl, prolong_cells, prolong_nodes, restrict_cells

# outer cycles of a composite solve at most (varden_tpu's DEFAULT_OUTER)
MAX_OUTER = 20
# V-cycles on the coarsest level inside each composite cc outer cycle
NV_COARSE = 2
# When a list, each composite solve appends one record as it ends: "cc" or
# "nodal", its outer cycles, the stopping tolerance and the roundoff floor
# within it (host floats), and the residual norm reached on each level
# (chip_smoke.py reads it for the AMR main path)
TRACE = None


def _bcov(arr, cov):
    """Covered-region index, passing leading batch axes through."""
    return (slice(None),) * (arr.ndim - len(cov)) + tuple(cov)


def _mean_sp(arr, dm):
    """Mean over the trailing spatial axes (keepdims: broadcasts back)."""
    return arr.mean(dim=tuple(range(arr.ndim - dm, arr.ndim)), keepdim=True)


def _axslice(f, axis, i0, i1):
    return f[_sl(f.ndim, axis, slice(i0, i1))]


def _solver_slab(fint, axis, side, ng, kind, code, bval):
    """Width-ng ghost slab realizing the solver BC on one side. Layer 1 uses
    the exact formula; outer layers copy it (they only feed interp
    slopes)."""
    if kind == "per":
        return (_axslice(fint, axis, -ng, None) if side == 0
                else _axslice(fint, axis, 0, ng))
    if side == 0:
        p0, p1 = _axslice(fint, axis, 0, 1), _axslice(fint, axis, 1, 2)
    else:
        p0, p1 = _axslice(fint, axis, -1, None), _axslice(fint, axis, -2, -1)
    if code == BC_NEU:
        g = p0
    elif code == BC_DIR:
        g = (8.0 / 3.0) * bval - 2.0 * p0 + (1.0 / 3.0) * p1
    else:  # BC_GHOST on a physical side does not occur; copy
        g = p0
    return torch.cat([g] * ng, dim=axis)


def pad_phi(geom: MLGeom, lev: int, phis, ell_bc_phys, bvals,
            ng: int = 1) -> torch.Tensor:
    """Padded solver variable at one level: physical sides by the solver BC
    formulas, periodic wrap, coarse-fine sides by unlimited linear
    interpolation from the parent's padded phi."""
    dm = geom.dm
    phi = phis[lev]

    if lev == 0:
        out = phi
        for d in range(dm):
            axis = out.ndim - dm + d
            kind = "per" if geom.sim.pmask[d] else "phys"
            lo = _solver_slab(out, axis, 0, ng, kind, ell_bc_phys[d][0],
                              bvals[d][0])
            hi = _solver_slab(out, axis, 1, ng, kind, ell_bc_phys[d][1],
                              bvals[d][1])
            out = torch.cat([lo, out, hi], dim=axis)
        return out

    par = geom.parent[lev]
    ppad = pad_phi(geom, par, phis, ell_bc_phys, bvals, ng=2)
    spec, pspec = geom.specs[lev], geom.specs[par]
    c0 = [(spec.lo[d] - ng) // 2 - 1 for d in range(dm)]
    c1 = [-((-(spec.hi[d] + ng)) // 2) + 1 for d in range(dm)]
    sl = [slice(None)] * (ppad.ndim - dm)
    for d in range(dm):
        origin = pspec.lo[d] - 2
        sl.append(slice(c0[d] - origin, c1[d] - origin))
    up = prolong_cells(ppad[tuple(sl)], dm, limit=False)
    del ppad
    sl = [slice(None)] * (up.ndim - dm)
    for d in range(dm):
        start = (spec.lo[d] - ng) - 2 * c0[d]
        sl.append(slice(start, start + spec.n[d] + 2 * ng))
    out = up[tuple(sl)].clone()
    del up
    out[tuple([slice(None)] * (out.ndim - dm) + [slice(ng, -ng)] * dm)] = phi

    for d in range(dm):
        axis = out.ndim - dm + d
        for side in range(2):
            kind = geom.side_kind(lev, d, side)
            if kind == "cf":
                continue
            fint = _axslice(out, axis, ng, -ng)
            slab = _solver_slab(fint, axis, side, ng, kind,
                                ell_bc_phys[d][side], bvals[d][side])
            dst = slice(0, ng) if side == 0 else slice(-ng, None)
            out[_sl(out.ndim, axis, dst)] = slab
    return out


def pad_corr(geom: MLGeom, lev: int, phi, ell_bc_phys,
             ng: int = 1) -> torch.Tensor:
    """Cheap pad for the correction cycle's defect: coarse-fine ghosts are
    ZERO (the parent correction is still zero on the down pass), physical
    sides use the homogeneous solver-BC slabs, periodic sides wrap."""
    dm = geom.dm
    out = phi
    for d in range(dm):
        axis = out.ndim - dm + d
        lo_k = geom.side_kind(lev, d, 0) if lev > 0 else (
            "per" if geom.sim.pmask[d] else "phys")
        hi_k = geom.side_kind(lev, d, 1) if lev > 0 else lo_k
        slabs = []
        for side, kind in ((0, lo_k), (1, hi_k)):
            if kind == "cf":
                shp = list(out.shape)
                shp[axis] = ng
                slabs.append(out.new_zeros(shp))
            else:
                slabs.append(_solver_slab(out, axis, side, ng, kind,
                                          ell_bc_phys[d][side], 0.0))
        out = torch.cat([slabs[0], out, slabs[1]], dim=axis)
    return out


def covered_slice_rel(geom: MLGeom, ci: int):
    """Slice of the PARENT tensor covered by child node ``ci``."""
    child, spec = geom.specs[ci], geom.specs[geom.parent[ci]]
    return tuple(slice(child.lo[d] // 2 - spec.lo[d],
                       child.hi[d] // 2 - spec.lo[d])
                 for d in range(geom.dm))


def _slab_cell(pad, d, dm, idx, cl, ch):
    """Cell plane from a 1-ghost padded coarse tensor, cropped to the
    covered tangential range (leading batch axes pass through)."""
    lead = pad.ndim - dm
    sl = [slice(None)] * lead
    for t in range(dm):
        sl.append(slice(idx, idx + 1) if t == d
                  else slice(cl[t] + 1, ch[t] + 1))
    return pad[tuple(sl)].squeeze(lead + d)


def _fine_plane(pad, d, dm, idx):
    lead = pad.ndim - dm
    sl = [slice(None)] * lead
    for t in range(dm):
        sl.append(slice(idx, idx + 1) if t == d else slice(1, -1))
    return pad[tuple(sl)].squeeze(lead + d)


def _beta_plane(beta, d, dm, face, cl, ch):
    if mg._is_scalar_coef(beta[d]):  # constant-coefficient operator
        return beta[d]
    sl = [slice(face, face + 1) if t == d else slice(cl[t], ch[t])
          for t in range(dm)]
    return beta[d][tuple(sl)].squeeze(d)


def _beta_plane_full(beta, d, dm, face):
    if mg._is_scalar_coef(beta[d]):
        return beta[d]
    sl = [slice(face, face + 1) if t == d else slice(None)
          for t in range(dm)]
    return beta[d][tuple(sl)].squeeze(d)


def _avg_plane(f, d, dm):
    """2x tangential average of a (dm-1)-plane (fine faces -> coarse)."""
    for t in range(dm - 1):
        ax = f.ndim - (dm - 1) + t
        f = 0.5 * (f[_sl(f.ndim, ax, slice(0, None, 2))]
                   + f[_sl(f.ndim, ax, slice(1, None, 2))])
    return f


def _reflux_correct(geom: MLGeom, ci, res_c, pad_c, pad_f, beta_c, beta_f):
    """Replace the coarse flux with the averaged fine flux in the coarse
    residual (in place) at the coarse-fine faces of child node ``ci`` (flux
    registers). pad_c=None means the coarse field is identically zero (the
    correction's down pass): the coarse flux term is skipped."""
    dm = geom.dm
    child = geom.specs[ci]
    par = geom.parent[ci]
    dxc, dxf = geom.dx(par), geom.dx(ci)
    cspec = geom.specs[par]
    cl = [child.lo[d] // 2 - cspec.lo[d] for d in range(dm)]
    ch = [child.hi[d] // 2 - cspec.lo[d] for d in range(dm)]
    lead = res_c.ndim - dm
    for d in range(dm):
        for side in range(2):
            if geom.side_kind(ci, d, side) != "cf":
                continue
            face_c = cl[d] if side == 0 else ch[d]  # coarse face plane
            # coarse flux across the plane: beta (phi[face]-phi[face-1])/dxc
            # from the padded coarse tensor (pad offset +1)
            if pad_c is None:
                Fc = 0.0
            else:
                lo_cell = _slab_cell(pad_c, d, dm, face_c, cl, ch)
                hi_cell = _slab_cell(pad_c, d, dm, face_c + 1, cl, ch)
                Fc = _beta_plane(beta_c, d, dm, face_c, cl, ch) * \
                    (hi_cell - lo_cell) / dxc[d]
            # fine flux on the coincident plane, averaged to coarse faces
            fface = 0 if side == 0 else child.n[d]
            f_lo = _fine_plane(pad_f, d, dm, fface)
            f_hi = _fine_plane(pad_f, d, dm, fface + 1)
            Ff = _beta_plane_full(beta_f, d, dm, fface) * (f_hi - f_lo) \
                / dxf[d]
            diff = (_avg_plane(Ff, d, dm) - Fc) / dxc[d]
            # r[left of the lo face] += diff; r[right of the hi face] -= diff
            cell = face_c - 1 if side == 0 else face_c
            sgn = 1.0 if side == 0 else -1.0
            idx = [slice(None)] * lead
            for t in range(dm):
                idx.append(slice(cell, cell + 1) if t == d
                           else slice(cl[t], ch[t]))
            res_c[tuple(idx)] += sgn * diff.unsqueeze(lead + d)
    return res_c


def _max_abs(ts):
    return torch.stack([t.abs().max() for t in ts]).max()


def _stop_test(level_norms, tol, diag_max, phis):
    """The residual norm of each level and the stopping tolerance on the
    host, in one read; also the roundoff floor. The tolerance includes the
    dtype's attainable floor (mg.roundoff_floor), as the single-level
    solvers have it: in float32 the composite residual of a fine hierarchy
    levels off there, above rel_eps * |rhs|; in float64 the floor lies far
    below the tolerances the steps ask for, so varden_tpu's stopping rule is
    unchanged there."""
    *norms, phi_max = torch.stack(list(level_norms)
                                  + [_max_abs(phis)]).tolist()
    floor = mg.roundoff_floor(diag_max, phi_max, phis[0].dtype)
    return norms, max(tol, floor), floor


def _trace(kind, iters, tol, floor, norms):
    if TRACE is not None:
        TRACE.append({"kind": kind, "outer": iters, "tol": tol,
                      "floor": floor, "level_res": norms})


def composite_cc_solve(geom: MLGeom, comp: int, rhs_l, aco_l, beta_l, alpha,
                       phi0_l=None, bvals=None, rel_eps=1e-10,
                       return_info=False):
    """Solve the composite problem (alpha*aco - div beta grad) phi = rhs over
    all levels. Returns (phi_l, resnorm), or (phi_l, (resnorm, outer cycles,
    ratio to the tolerance)) with return_info. rhs may carry a leading
    batch axis (one operator, several fields); ``bvals`` entries may then be
    tensors broadcasting over it (per-component boundary values). Each outer
    cycle visits a fine level with one V-cycle on the way down and one on
    the way up (over-solving a fine level against its homogeneous interface
    ghosts stalls the composite iteration) and the coarsest with
    NV_COARSE."""
    sim = geom.sim
    dm, nlev = geom.dm, geom.nlev
    ell0 = [tuple(sim.ell_bc[comp][d]) for d in range(dm)]
    if bvals is None:
        bvals = [[0.0, 0.0]] * dm
    if phi0_l is None:
        phi0_l = [torch.zeros_like(r) for r in rhs_l]
    if nlev == 1:
        phi, info = mg.solve(geom.specs[0].n, geom.dx(0), ell0, aco_l[0],
                             beta_l[0], rhs_l[0], alpha=alpha, bvals=bvals,
                             phi0=phi0_l[0], rel_eps=rel_eps,
                             return_info=return_info)
        return [phi], info

    ell_bcs = [ell0] + [geom.ell_bc_level(l, comp) for l in range(1, nlev)]
    hiers = [mg.build_hierarchy(list(geom.specs[l].n), list(geom.dx(l)),
                                ell_bcs[l], aco_l[l], list(beta_l[l]), alpha)
             for l in range(nlev)]
    # composite null space = constants iff the level-0 problem is singular
    singular = mg.is_singular(ell0, alpha)
    if singular:
        # make the rhs compatible with the COMPOSITE left null vector
        # (uniform over coarse cells with covered entries = restriction of
        # fine): an incompatible component only circulates between levels
        # through the reflux and stalls convergence
        folded = [r.clone() for r in rhs_l]
        for c in range(nlev - 1, 0, -1):
            p_ = geom.parent[c]
            folded[p_][_bcov(folded[p_], covered_slice_rel(geom, c))] = \
                restrict_cells(folded[c], dm)
        mu = _mean_sp(folded[0], dm)
        del folded
        rhs_l = [r - mu for r in rhs_l]

    def residuals(phis):
        pads = [pad_phi(geom, l, phis, ell0, bvals, ng=1)
                for l in range(nlev)]
        res = [rhs_l[l] - mg.apply_padded(pads[l], aco_l[l], beta_l[l],
                                          alpha, geom.dx(l), dm)
               for l in range(nlev)]
        # fold FINE -> COARSE (children in reverse node order) so that a
        # middle node's covered / reflux corrections are in place before it
        # is restricted into its own parent
        for c in range(nlev - 1, 0, -1):
            p = geom.parent[c]
            _reflux_correct(geom, c, res[p], pads[p], pads[c], beta_l[p],
                            beta_l[c])
            res[p][_bcov(res[p], covered_slice_rel(geom, c))] = \
                restrict_cells(res[c], dm)
        return res

    def level_norms(res):
        if singular:
            # project out the composite incompatibility (constant) component
            m = _mean_sp(res[0], dm)
            return [(r - m).abs().max() for r in res]
        return [r.abs().max() for r in res]

    tol = rel_eps * float(_max_abs(rhs_l))

    def slave(phis):
        for c in range(nlev - 1, 0, -1):
            p = geom.parent[c]
            phis[p][_bcov(phis[p], covered_slice_rel(geom, c))] = \
                restrict_cells(phis[c], dm)
        return phis

    zb = [[0.0, 0.0]] * dm

    def comp_correction(res):
        """One composite V-cycle on the correction problem A_comp d = res
        (homogeneous BCs), the ml_cc structure (FBoxLib ml_cc.f90 via
        mac_multigrid.f90:53-62). Fine-to-coarse node order visits every
        child before its parent; siblings land in disjoint parent regions.
        ``res`` is consumed (updated in place)."""
        d = [torch.zeros_like(r) for r in res]
        for c in range(nlev - 1, 0, -1):
            p = geom.parent[c]
            d[c] = mg.v_cycle(hiers[c], d[c], res[c], zb)
            # on the down pass the parent correction is still zero: the
            # child's cf ghosts are zero and the parent-side reflux flux
            # vanishes
            pad_f = pad_corr(geom, c, d[c], ell0, ng=1)
            dres = res[c] - mg.apply_padded(pad_f, aco_l[c], beta_l[c],
                                            alpha, geom.dx(c), dm)
            res[p][_bcov(res[p], covered_slice_rel(geom, c))] = \
                restrict_cells(dres, dm)
            _reflux_correct(geom, c, res[p], None, pad_f, beta_l[p],
                            beta_l[c])
        r0 = res[0] - _mean_sp(res[0], dm) if singular else res[0]
        for _ in range(NV_COARSE):
            d[0] = mg.v_cycle(hiers[0], d[0], r0, zb, singular=singular)
        for c in range(1, nlev):
            dp = d[geom.parent[c]]
            # plain linear prolongation: a limiter on the correction clamps
            # it at extrema and weakens the per-outer contraction
            d[c] = d[c] + prolong_cells(dp[_bcov(dp,
                                                 covered_slice_rel(geom, c))],
                                        dm, limit=False)
            pad = pad_phi(geom, c, d, ell0, zb, ng=1)
            rl = res[c] - mg.apply_padded(pad, aco_l[c], beta_l[c], alpha,
                                          geom.dx(c), dm)
            del pad
            d[c] = d[c] + mg.v_cycle(hiers[c], torch.zeros_like(rl), rl, zb)
        return d

    diag_max = float(_max_abs([h[0].diag for h in hiers]))
    phis = slave([p.clone() for p in phi0_l])
    res = residuals(phis)
    norms_t = level_norms(res)
    iters = 0
    # one composite residual per outer cycle: the residual computed for the
    # stop test is the next correction's source
    norms, tol_h, floor = _stop_test(norms_t, tol, diag_max, phis)
    while iters < MAX_OUTER and max(norms) > tol_h:
        d = comp_correction(res)
        phis = slave([p + di for p, di in zip(phis, d)])
        del d
        if singular:
            m = _mean_sp(phis[0], dm)
            phis = [p - m for p in phis]
        res = residuals(phis)
        norms_t = level_norms(res)
        iters += 1
        norms, tol_h, floor = _stop_test(norms_t, tol, diag_max, phis)
    _trace("cc", iters, tol, floor, norms)
    rn = torch.stack(norms_t).max()
    if return_info:
        tiny = torch.finfo(rn.dtype).tiny
        return phis, (rn, iters, rn / max(tol_h, tiny))
    return phis, rn


# ---------------------------------------------------------------------------
# composite nodal solve
# ---------------------------------------------------------------------------

def _wrap_periodic_nodes(geom: MLGeom, par, pc):
    """Append node 0 on the parent's periodic axes so that prolongation
    covers the last midpoint."""
    for d in range(geom.dm):
        if geom.side_kind(par, d, 0) == "per":
            pc = torch.cat([pc, pc.narrow(d, 0, 1)], dim=d)
    return pc


def _interface_values(geom: MLGeom, lev, phi_c):
    """Fine-node boundary values on the cf sides of node ``lev``,
    interpolated from its parent's nodal phi (linear along the interface)."""
    dm = geom.dm
    par = geom.parent[lev]
    spec, pspec = geom.specs[lev], geom.specs[par]
    up = prolong_nodes(_wrap_periodic_nodes(geom, par, phi_c), dm)
    vals = {}
    for d in range(dm):
        for side in range(2):
            if geom.side_kind(lev, d, side) != "cf":
                continue
            fnode = spec.lo[d] if side == 0 else spec.hi[d]
            sl = []
            for t in range(dm):
                if t == d:
                    i = fnode - 2 * pspec.lo[t]
                    sl.append(slice(i, i + 1))
                else:
                    fn_t = spec.n[t] + (0 if geom.side_kind(lev, t, 0)
                                        == "per" else 1)
                    i = spec.lo[t] - 2 * pspec.lo[t]
                    sl.append(slice(i, i + fn_t))
            vals[(d, side)] = up[tuple(sl)].squeeze(d)
    return vals


def _set_interface(geom: MLGeom, lev, phi_f, vals):
    """Write the interface values into phi_f (in place)."""
    for (d, side), v in vals.items():
        edge = slice(0, 1) if side == 0 else slice(-1, None)
        phi_f[_sl(geom.dm, d, edge)] = v.unsqueeze(d)
    return phi_f


def fine_nodal_mask(geom: MLGeom, lev):
    """1 = solve, 0 = fixed: the cf boundary nodes and any physical
    Dirichlet (outlet) node."""
    dm = geom.dm
    sim = geom.sim
    ns = nodal.node_shape(geom.specs[lev].n, geom.pmask_level(lev))
    mask = torch.ones(ns, dtype=sim.dtype, device=sim.device)
    for d in range(dm):
        for side in range(2):
            kind = geom.side_kind(lev, d, side)
            if kind == "cf" or (kind == "phys"
                                and sim.phys_bc[d][side] == OUTLET):
                edge = slice(0, 1) if side == 0 else slice(-1, None)
                mask[_sl(dm, d, edge)] = 0.0
    return mask


def _prolong_node_patch(geom: MLGeom, lev, dc):
    """Prolong a parent nodal correction onto node ``lev``'s lattice."""
    dm = geom.dm
    par = geom.parent[lev]
    spec, pspec = geom.specs[lev], geom.specs[par]
    up = prolong_nodes(_wrap_periodic_nodes(geom, par, dc), dm)
    sl = []
    for d in range(dm):
        fn = spec.n[d] + (0 if geom.side_kind(lev, d, 0) == "per" else 1)
        i = spec.lo[d] - 2 * pspec.lo[d]
        sl.append(slice(i, i + fn))
    return up[tuple(sl)]


def composite_nodal_solve(geom: MLGeom, sigma_l, vel_l, inflow_pad_l=None,
                          return_info=False, phi0_l=None, rel_eps=1e-10):
    """Composite nodal (hg) solve over the hierarchy: the slave-node
    composite FEM problem (FBoxLib ml_nd_solve semantics, consumed via
    hg_multigrid.f90:95-105).

    The composite residual at a coarse interface node carries both sides:
    the uncovered-cell coarse contributions plus the P^T-restricted fine-cell
    contributions (the nodal flux-register role). Fine midpoint nodes on the
    interface are slaves (linear interpolation of the coarse trace) whose
    residuals fold into their master rows through P^T.

    vel_l: (dm, *cells) velocity per level, which splits the weak-form RHS
    into covered / uncovered cell contributions. Returns (phi_l, resnorm) or
    with return_info (phi_l, (resnorm, outer cycles, ratio))."""
    sim = geom.sim
    dm, nlev = geom.dm, geom.nlev
    pmask_l = [geom.pmask_level(l) for l in range(nlev)]
    if inflow_pad_l is None:
        inflow_pad_l = [None] * nlev
    rhs_l = [nodal.divu_rhs(vel_l[l], geom.dx(l), pmask_l[l], dm,
                            inflow_pad=inflow_pad_l[l])
             for l in range(nlev)]
    if nlev == 1:
        phi, info = nodal.solve(geom.specs[0].n, geom.dx(0), sim.pmask,
                                sigma_l[0], rhs_l[0], mask=sim.nodal_mask(),
                                phi0=None if phi0_l is None else phi0_l[0],
                                rel_eps=rel_eps, return_info=return_info)
        return [phi], info

    mask0 = sim.nodal_mask()
    masks = [mask0] + [fine_nodal_mask(geom, l) for l in range(1, nlev)]
    singular = mask0 is None

    # sigma folded coarse-ward (the composite coefficient of the correction
    # hierarchies) and the uncovered-only coefficient / velocity
    sig_t = list(sigma_l)
    for c in range(nlev - 1, 0, -1):
        p = geom.parent[c]
        if sig_t[p] is sigma_l[p]:
            sig_t[p] = sig_t[p].clone()
        sig_t[p][covered_slice_rel(geom, c)] = restrict_cells(sig_t[c], dm)
    lev_uncov, rhs_uncov = [None] * nlev, [None] * nlev
    # A fine level that fixes no node (it covers the domain and has no
    # outlet side) has the constants as its correction problem's null
    # space, as a singular base level has: its hierarchy regularises them
    # (mask None). With a mask of ones the dense bottom operator is
    # singular and its inverse is roundoff-sized noise of order 1e15.
    hmask = [None if m is not None and bool((m != 0).all()) else m
             for m in masks]
    hiers = [nodal.build_hierarchy(list(geom.specs[l].n), list(geom.dx(l)),
                                   pmask_l[l], sig_t[l], hmask[l])
             for l in range(nlev)]
    # unmasked-apply levels: the true per-level coefficients for residuals
    lev_true = [nodal.NodalLevel(tuple(geom.specs[l].n), tuple(geom.dx(l)),
                                 tuple(pmask_l[l]), sigma_l[l],
                                 hiers[l][0].diag, None)
                for l in range(nlev)]
    for l in range(nlev):
        if not geom.children[l]:
            continue
        su, vu = sigma_l[l].clone(), vel_l[l].clone()
        keep = torch.ones_like(su)
        for c in geom.children[l]:
            cov = covered_slice_rel(geom, c)
            su[cov] = 0.0
            vu[(slice(None),) + cov] = 0.0
            keep[cov] = 0.0
        lev_uncov[l] = nodal.NodalLevel(lev_true[l].n, lev_true[l].dx,
                                        lev_true[l].pmask, su,
                                        lev_true[l].diag, None)
        # an inlet face's ghost velocity beside a covered cell belongs to
        # the child's rows, which take it through their own inflow pad
        # (varden_tpu counts it in both: ROADMAP.md section 3)
        rhs_uncov[l] = nodal.divu_rhs(vu, geom.dx(l), pmask_l[l], dm,
                                      inflow_pad=inflow_pad_l[l], keep=keep)
        del vu

    if phi0_l is None:
        phis = [torch.zeros(nodal.node_shape(geom.specs[l].n, pmask_l[l]),
                            dtype=sim.dtype, device=sim.device)
                for l in range(nlev)]
    else:
        phis = [p.clone() for p in phi0_l]

    def covered_nodes(ci, full):
        """Parent-node window coincident with child ``ci``'s lattice;
        ``full`` includes the interface ring on cf sides."""
        child, spec = geom.specs[ci], geom.specs[geom.parent[ci]]
        sl = []
        for d in range(dm):
            lo = child.lo[d] // 2 - spec.lo[d]
            hi = child.hi[d] // 2 - spec.lo[d] + 1
            if geom.side_kind(ci, d, 0) == "per":
                hi -= 1
            elif not full and geom.side_kind(ci, d, 0) == "cf":
                lo += 1
            if not full and geom.side_kind(ci, d, 1) == "cf":
                hi -= 1
            sl.append(slice(lo, hi))
        return tuple(sl)

    def fine_node_window(ci):
        """Strided slices into child ``ci``'s node tensor giving the nodes
        coincident with covered_nodes(ci, False)."""
        child = geom.specs[ci]
        sl = []
        for d in range(dm):
            per = geom.side_kind(ci, d, 0) == "per"
            count = child.n[d] + (0 if per else 1)
            lo = 2 if geom.side_kind(ci, d, 0) == "cf" else 0
            stop = count - 2 if geom.side_kind(ci, d, 1) == "cf" else count
            sl.append(slice(lo, stop + 1, 2))
        return tuple(sl)

    def set_interfaces(phis):
        for l in range(1, nlev):
            _set_interface(geom, l, phis[l],
                           _interface_values(geom, l, phis[geom.parent[l]]))
        return phis

    def comp_residuals(phis):
        """Unmasked composite residual per node, folded fine -> coarse:
        leaf rows b - A phi; covered and interface rows of a parent =
        uncovered-cell part + P^T(each child's residual)."""
        res = [None] * nlev
        for l in range(nlev - 1, -1, -1):
            if not geom.children[l]:
                res[l] = rhs_l[l] - nodal.nd_apply_raw(lev_true[l], phis[l])
                continue
            r_own = rhs_uncov[l] - nodal.nd_apply_raw(lev_uncov[l], phis[l])
            for c in geom.children[l]:
                r_own[covered_nodes(c, True)] += ck.node_restrict(
                    res[c], pmask_l[c], dm)
            res[l] = r_own
        return res

    def level_norms(res):
        r0 = res[0] if masks[0] is None else res[0] * masks[0]
        r0 = r0 - r0.mean() if singular else r0
        return [r0.abs().max()] + [(res[l] * masks[l]).abs().max()
                                   for l in range(1, nlev)]

    def comp_correction(res):
        """One recursive composite V-cycle on A_comp d = res (homogeneous
        interface and physical BCs), the ml_nd structure. ``res`` is
        consumed (updated in place)."""
        d = [torch.zeros_like(r) for r in res]
        for l in range(nlev - 1, 0, -1):
            p = geom.parent[l]
            d[l] = nodal.v_cycle(hiers[l], d[l], res[l] * masks[l]) * masks[l]
            # fold the correction's composite defect into the parent rows
            res[p][covered_nodes(l, True)] += ck.node_restrict(
                -nodal.nd_apply_raw(hiers[l][0], d[l]), pmask_l[l], dm)
        r0 = res[0]
        if singular:
            r0 = r0 - r0.mean()
        if masks[0] is not None:
            r0 = r0 * masks[0]
        d[0] = nodal.v_cycle(hiers[0], d[0], r0)
        for l in range(1, nlev):
            # interface rows get the parent-interpolated trace
            d[l] = d[l] + _prolong_node_patch(geom, l, d[geom.parent[l]])
            rl = (res[l] - nodal.nd_apply_raw(hiers[l][0], d[l])) * masks[l]
            d[l] = d[l] + nodal.v_cycle(hiers[l], torch.zeros_like(rl),
                                        rl) * masks[l]
        return d

    def slave(phis):
        for c in range(nlev - 1, 0, -1):
            p = geom.parent[c]
            phis[p][covered_nodes(c, False)] = phis[c][fine_node_window(c)]
        return phis

    tol = rel_eps * float(_max_abs(rhs_l))
    diag_max = float(_max_abs([h[0].diag for h in hiers]))
    phis = set_interfaces(phis)
    res = comp_residuals(phis)
    norms_t = level_norms(res)
    iters = 0
    norms, tol_h, floor = _stop_test(norms_t, tol, diag_max, phis)
    while iters < MAX_OUTER and max(norms) > tol_h:
        d = comp_correction(res)
        phis = [p + di for p, di in zip(phis, d)]
        del d
        phis = slave(set_interfaces(phis))
        if singular:
            m = phis[0].mean()
            phis = [p - m for p in phis]
        res = comp_residuals(phis)
        norms_t = level_norms(res)
        iters += 1
        norms, tol_h, floor = _stop_test(norms_t, tol, diag_max, phis)
    _trace("nodal", iters, tol, floor, norms)
    rn = torch.stack(norms_t).max()
    phis = set_interfaces(phis)
    if return_info:
        tiny = torch.finfo(rn.dtype).tiny
        return phis, (rn, iters, rn / max(tol_h, tiny))
    return phis, rn
