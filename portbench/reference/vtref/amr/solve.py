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

Under a mesh every level's tensors are the rank's blocks (fill.MLGeom):
each patch's V-cycles are the decomposed single-level ones (its Decomp,
or none for a patch too small to cut, which every rank then solves
whole), the coarse-fine ghosts and prolongations fetch the parent's
window, the restrictions and the nodal residual folds put into the
parent's blocks, and the norms are reduced over the ranks.
"""
from __future__ import annotations

import torch

from ..bc import BC_DIR, BC_NEU
from ..config import OUTLET
from ..ops import cuda_kernels as ck
from ..parallel import halo
from ..parallel import mesh as pmesh
from ..solvers import mg, nodal
from .fill import (MLGeom, child_image, fill_sides, interp_window, level_max,
                   put_into_parent)
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
    interpolation from the parent's padded phi, a decomposed block's
    internal faces from its neighbours."""
    dm = geom.dm
    phi = phis[lev]

    if lev == 0:
        dec = geom.decs[0]
        out = phi
        for d in range(dm):
            axis = out.ndim - dm + d
            got = (None, None) if dec is None else \
                halo.exchange(out, dec, d, ng, ng)
            kind = "per" if geom.bpmask(0)[d] else "phys"
            lo, hi = got
            if lo is None:
                lo = _solver_slab(out, axis, 0, ng, kind, ell_bc_phys[d][0],
                                  bvals[d][0])
            if hi is None:
                hi = _solver_slab(out, axis, 1, ng, kind, ell_bc_phys[d][1],
                                  bvals[d][1])
            out = torch.cat([lo, out, hi], dim=axis)
        return out

    ppad = pad_phi(geom, geom.parent[lev], phis, ell_bc_phys, bvals, ng=2)
    out = interp_window(geom, lev, ppad, 2, ng, limit=False)
    del ppad
    out[tuple([slice(None)] * (out.ndim - dm) + [slice(ng, -ng)] * dm)] = phi

    def slab(fint, axis, side, kind):
        d = axis - (fint.ndim - dm)
        return _solver_slab(fint, axis, side, ng, kind, ell_bc_phys[d][side],
                            bvals[d][side])

    return fill_sides(geom, lev, out, ng, slab)


def pad_corr(geom: MLGeom, lev: int, phi, ell_bc_phys,
             ng: int = 1) -> torch.Tensor:
    """Cheap pad for the correction cycle's defect: coarse-fine ghosts are
    ZERO (the parent correction is still zero on the down pass), physical
    sides use the homogeneous solver-BC slabs, periodic sides wrap, a
    decomposed block's internal faces take the neighbours' cells."""
    dm = geom.dm
    dec = geom.decs[lev]
    out = phi
    for d in range(dm):
        axis = out.ndim - dm + d
        got = (None, None) if dec is None else \
            halo.exchange(out, dec, d, ng, ng)
        slabs = []
        for side in range(2):
            kind = geom.bkind(lev, d, side)
            if kind == "int":
                slabs.append(got[side])
            elif kind == "cf":
                shp = list(out.shape)
                shp[axis] = ng
                slabs.append(out.new_zeros(shp))
            else:
                if lev == 0:
                    kind = "per" if geom.bpmask(0)[d] else "phys"
                slabs.append(_solver_slab(out, axis, side, ng, kind,
                                          ell_bc_phys[d][side], 0.0))
        out = torch.cat([slabs[0], out, slabs[1]], dim=axis)
    return out


def covered_block(geom: MLGeom, ci: int):
    """The part of the rank's block of the parent that child ``ci``
    covers, as a block-local slice, or None."""
    par = geom.parent[ci]
    dec = geom.decs[par]
    plo = (0,) * geom.dm if dec is None else dec.lo
    pn = geom.bn(par)
    lo, hi = child_image_full(geom, ci)
    out = []
    for d in range(geom.dm):
        a, b = max(lo[d], plo[d]), min(hi[d], plo[d] + pn[d])
        if b <= a:
            return None
        out.append(slice(a - plo[d], b - plo[d]))
    return tuple(out)


def child_image_full(geom: MLGeom, ci: int):
    """The parent cells (lo, hi), parent-patch index, child ``ci``
    covers."""
    child, spec = geom.specs[ci], geom.specs[geom.parent[ci]]
    return (tuple(child.lo[d] // 2 - spec.lo[d] for d in range(geom.dm)),
            tuple(child.hi[d] // 2 - spec.lo[d] for d in range(geom.dm)))


def covered_slice_rel(geom: MLGeom, ci: int):
    """Slice of the PARENT tensor covered by child node ``ci``."""
    child, spec = geom.specs[ci], geom.specs[geom.parent[ci]]
    return tuple(slice(child.lo[d] // 2 - spec.lo[d],
                       child.hi[d] // 2 - spec.lo[d])
                 for d in range(geom.dm))


def _beta_plane(beta, d, dm, face, cl, ch):
    if mg._is_scalar_coef(beta[d]):  # constant-coefficient operator
        return beta[d]
    sl = [slice(face, face + 1) if t == d else slice(cl[t], ch[t])
          for t in range(dm)]
    return beta[d][tuple(sl)].squeeze(d)


def _avg_plane(f, d, dm):
    """2x tangential average of a (dm-1)-plane (fine faces -> coarse)."""
    for t in range(dm - 1):
        ax = f.ndim - (dm - 1) + t
        f = 0.5 * (f[_sl(f.ndim, ax, slice(0, None, 2))]
                   + f[_sl(f.ndim, ax, slice(1, None, 2))])
    return f


def _reflux_box(geom: MLGeom, ci, d, side, r):
    """The coarse cells beside child ``ci``'s coarse-fine face (d, side)
    that rank r's block of the parent holds: (lo, hi) in the parent
    patch's index, or None."""
    dm = geom.dm
    child = geom.specs[ci]
    par = geom.parent[ci]
    cspec = geom.specs[par]
    dec = geom.decs[par]
    plo = (0,) * dm if dec is None else dec.of_rank(r).lo
    pn = geom.bn(par)
    cl = [child.lo[t] // 2 - cspec.lo[t] for t in range(dm)]
    ch = [child.hi[t] // 2 - cspec.lo[t] for t in range(dm)]
    cell = cl[d] - 1 if side == 0 else ch[d]
    lo, hi = [], []
    for t in range(dm):
        a, b = (cell, cell + 1) if t == d else (cl[t], ch[t])
        a, b = max(a, plo[t]), min(b, plo[t] + pn[t])
        if b <= a:
            return None
        lo.append(a)
        hi.append(b)
    return tuple(lo), tuple(hi)


def _fine_box(geom: MLGeom, ci, d, side, r, planes):
    """The child's entries under _reflux_box(r): along d ``planes`` given
    as (lo, hi) in the child's index, tangentially the fine cells of the
    box's coarse cells."""
    box = _reflux_box(geom, ci, d, side, r)
    if box is None:
        return None
    child, cspec = geom.specs[ci], geom.specs[geom.parent[ci]]
    lo, hi = [], []
    for t in range(geom.dm):
        if t == d:
            lo.append(planes[0])
            hi.append(planes[1])
        else:
            cl = child.lo[t] // 2 - cspec.lo[t]
            lo.append(2 * (box[0][t] - cl))
            hi.append(2 * (box[1][t] - cl))
    return tuple(lo), tuple(hi)


def _reflux_correct(geom: MLGeom, ci, res_c, pad_c, pad_f, beta_c, beta_f):
    """Replace the coarse flux with the averaged fine flux in the coarse
    residual (in place) at the coarse-fine faces of child node ``ci`` (flux
    registers). pad_c=None means the coarse field is identically zero (the
    correction's down pass): the coarse flux term is skipped. Each rank
    corrects the cells its block of the parent holds, from the child's
    planes fetched under them."""
    dm = geom.dm
    child = geom.specs[ci]
    par = geom.parent[ci]
    dxc, dxf = geom.dx(par), geom.dx(ci)
    dec_c, dec_f = geom.decs[par], geom.decs[ci]
    me = pmesh.rank()
    plo = (0,) * dm if dec_c is None else dec_c.lo
    lead = res_c.ndim - dm
    for d in range(dm):
        for side in range(2):
            if geom.side_kind(ci, d, side) != "cf":
                continue
            # the fine cells on both sides of the plane (pad_f holds one
            # ghost) and the fine face coefficient on it
            fface = 0 if side == 0 else child.n[d]
            planes = (fface - 1, fface + 1)
            two = halo.fetch(pad_f, dec_f, lambda r: _fine_box(
                geom, ci, d, side, r, planes), pad=1)
            bf = beta_f[d]
            if not mg._is_scalar_coef(bf):
                bf = halo.fetch(bf, dec_f, lambda r: _fine_box(
                    geom, ci, d, side, r, (fface, fface + 1)), kind=d)
            box = _reflux_box(geom, ci, d, side, me)
            if box is None:
                continue
            lead2 = two.ndim - dm
            f_lo = two.narrow(lead2 + d, 0, 1).squeeze(lead2 + d)
            f_hi = two.narrow(lead2 + d, 1, 1).squeeze(lead2 + d)
            if not mg._is_scalar_coef(bf):
                bf = bf.squeeze(d)
            Ff = bf * (f_hi - f_lo) / dxf[d]
            # coarse cells (block-local) and the coarse face plane
            cl = [box[0][t] - plo[t] for t in range(dm)]
            ch = [box[1][t] - plo[t] for t in range(dm)]
            cell = cl[d]
            face_c = cell + 1 if side == 0 else cell
            if pad_c is None:
                Fc = 0.0
            else:
                # the coarse flux across the plane from the padded coarse
                # tensor (pad offset +1)
                lo_cell = _slab_cell(pad_c, d, dm, face_c, cl, ch)
                hi_cell = _slab_cell(pad_c, d, dm, face_c + 1, cl, ch)
                Fc = _beta_plane(beta_c, d, dm, face_c, cl, ch) * \
                    (hi_cell - lo_cell) / dxc[d]
            diff = (_avg_plane(Ff, d, dm) - Fc) / dxc[d]
            # r[left of the lo face] += diff; r[right of the hi face] -= diff
            sgn = 1.0 if side == 0 else -1.0
            idx = [slice(None)] * lead
            for t in range(dm):
                idx.append(slice(cell, cell + 1) if t == d
                           else slice(cl[t], ch[t]))
            res_c[tuple(idx)] += sgn * diff.unsqueeze(lead + d)
    return res_c


def _slab_cell(pad, d, dm, idx, cl, ch):
    """Cell plane from a 1-ghost padded coarse tensor, cropped to the
    covered tangential range (leading batch axes pass through)."""
    lead = pad.ndim - dm
    sl = [slice(None)] * lead
    for t in range(dm):
        sl.append(slice(idx, idx + 1) if t == d
                  else slice(cl[t] + 1, ch[t] + 1))
    return pad[tuple(sl)].squeeze(lead + d)


def _max_abs(geom: MLGeom, ts):
    """max|t| over the tensors (and over the ranks under a mesh)."""
    return level_max(geom, torch.stack([t.abs().max() for t in ts]).max())


def _reduced_stop_test(geom: MLGeom, level_norms, tol, diag_max, phis):
    """_stop_test on the norms and max|phi| of the whole hierarchy: one
    reduction over the ranks under a mesh."""
    red = level_max(geom, torch.stack(
        list(level_norms) + [torch.stack([p.abs().max()
                                          for p in phis]).max()]))
    return _stop_test(list(red[:-1]), tol, diag_max, [red[-1]])


def _stop_test(level_norms, tol, diag_max, phis):
    """The residual norm of each level and the stopping tolerance on the
    host, in one read; also the roundoff floor. The tolerance includes the
    dtype's attainable floor (mg.roundoff_floor), as the single-level
    solvers have it: in float32 the composite residual of a fine hierarchy
    levels off there, above rel_eps * |rhs|; in float64 the floor lies far
    below the tolerances the steps ask for, so varden_tpu's stopping rule is
    unchanged there."""
    *norms, phi_max = torch.stack(list(level_norms)
                                  + [torch.stack([p.abs().max()
                                                  for p in phis]).max()]
                                  ).tolist()
    floor = mg.roundoff_floor(diag_max, phi_max, phis[0].dtype)
    return norms, max(tol, floor), floor


def _trace(kind, iters, tol, floor, norms):
    if TRACE is not None:
        TRACE.append({"kind": kind, "outer": iters, "tol": tol,
                      "floor": floor, "level_res": norms})


def prolong_covered(geom: MLGeom, c, dp):
    """The parent correction ``dp`` over the rank's block of child ``c``,
    by plain linear prolongation of the covered parent cells (the window
    fetched with one cell of slope halo inside the covered region; its
    outermost cells keep zero slope there, as on the whole region)."""
    dm = geom.dm
    child, pspec = geom.specs[c], geom.specs[geom.parent[c]]
    cl = [child.lo[t] // 2 - pspec.lo[t] for t in range(dm)]
    ch = [child.hi[t] // 2 - pspec.lo[t] for t in range(dm)]

    def win(r):
        lo, hi = child_image(geom, c, r)
        return (tuple(max(l - 1, a) for l, a in zip(lo, cl)),
                tuple(min(h + 1, b) for h, b in zip(hi, ch)))

    w = halo.fetch(dp, geom.decs[geom.parent[c]], win)
    up = prolong_cells(w, dm, limit=False)
    wlo = win(pmesh.rank())[0]
    ilo = child_image(geom, c, pmesh.rank())[0]
    n = geom.bn(c)
    sl = (slice(None),) * (up.ndim - dm) + tuple(
        slice(2 * (i - l), 2 * (i - l) + b) for i, l, b in zip(ilo, wlo, n))
    return up[sl]


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
        phi, info = mg.solve(geom.bn(0), geom.dx(0), ell0, aco_l[0],
                             beta_l[0], rhs_l[0], alpha=alpha, bvals=bvals,
                             phi0=phi0_l[0], rel_eps=rel_eps,
                             return_info=return_info, dec=geom.decs[0])
        return [phi], info

    ell_bcs = [ell0] + [geom.ell_bc_level(l, comp) for l in range(1, nlev)]
    hiers = [mg.build_hierarchy(list(geom.bn(l)), list(geom.dx(l)),
                                ell_bcs[l], aco_l[l], list(beta_l[l]), alpha,
                                dec=geom.sdec(l))
             for l in range(nlev)]
    dec0 = geom.decs[0]
    # composite null space = constants iff the level-0 problem is singular
    singular = mg.is_singular(ell0, alpha)
    if singular:
        # make the rhs compatible with the COMPOSITE left null vector
        # (uniform over coarse cells with covered entries = restriction of
        # fine): an incompatible component only circulates between levels
        # through the reflux and stalls convergence
        folded = [r.clone() for r in rhs_l]
        for c in range(nlev - 1, 0, -1):
            put_into_parent(geom, c, folded[geom.parent[c]],
                            restrict_cells(folded[c], dm))
        mu = mg._mean_sp(folded[0], dm, dec0)
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
            put_into_parent(geom, c, res[p], restrict_cells(res[c], dm))
        return res

    def level_norms(res):
        if singular:
            # project out the composite incompatibility (constant) component
            m = mg._mean_sp(res[0], dm, dec0)
            return [(r - m).abs().max() for r in res]
        return [r.abs().max() for r in res]

    tol = rel_eps * float(_max_abs(geom, rhs_l))

    def slave(phis):
        for c in range(nlev - 1, 0, -1):
            put_into_parent(geom, c, phis[geom.parent[c]],
                            restrict_cells(phis[c], dm))
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
            put_into_parent(geom, c, res[p], restrict_cells(dres, dm))
            _reflux_correct(geom, c, res[p], None, pad_f, beta_l[p],
                            beta_l[c])
        r0 = res[0] - mg._mean_sp(res[0], dm, dec0) if singular else res[0]
        for _ in range(NV_COARSE):
            d[0] = mg.v_cycle(hiers[0], d[0], r0, zb, singular=singular)
        for c in range(1, nlev):
            # plain linear prolongation: a limiter on the correction clamps
            # it at extrema and weakens the per-outer contraction
            d[c] = d[c] + prolong_covered(geom, c, d[geom.parent[c]])
            pad = pad_phi(geom, c, d, ell0, zb, ng=1)
            rl = res[c] - mg.apply_padded(pad, aco_l[c], beta_l[c], alpha,
                                          geom.dx(c), dm)
            del pad
            d[c] = d[c] + mg.v_cycle(hiers[c], torch.zeros_like(rl), rl, zb)
        return d

    diag_max = float(_max_abs(geom, [h[0].diag for h in hiers]))
    phis = slave([p.clone() for p in phi0_l])
    res = residuals(phis)
    norms_t = level_norms(res)
    iters = 0
    # one composite residual per outer cycle: the residual computed for the
    # stop test is the next correction's source
    norms, tol_h, floor = _reduced_stop_test(geom, norms_t, tol, diag_max,
                                             phis)
    while iters < MAX_OUTER and max(norms) > tol_h:
        d = comp_correction(res)
        phis = slave([p + di for p, di in zip(phis, d)])
        del d
        if singular:
            m = mg._mean_sp(phis[0], dm, dec0)
            phis = [p - m for p in phis]
        res = residuals(phis)
        norms_t = level_norms(res)
        iters += 1
        norms, tol_h, floor = _reduced_stop_test(geom, norms_t, tol, diag_max,
                                             phis)
    _trace("cc", iters, tol, floor, norms)
    rn = level_max(geom, torch.stack(norms_t).max())
    if return_info:
        tiny = torch.finfo(rn.dtype).tiny
        return phis, (rn, iters, rn / max(tol_h, tiny))
    return phis, rn


# ---------------------------------------------------------------------------
# composite nodal solve
# ---------------------------------------------------------------------------

def _node_count(geom: MLGeom, l, d):
    """The patch's nodes along axis d (a periodic patch axis wraps)."""
    return geom.specs[l].n[d] + (0 if geom.pmask_level(l)[d] else 1)


def _node_held(geom: MLGeom, l, r):
    """The nodes rank r's block of patch ``l`` holds, (lo, hi) in the
    patch's node index: the block's closure along a split axis (its last
    node the hi neighbour's first), every node along the others."""
    dec = geom.decs[l]
    lo, hi = [], []
    for d in range(geom.dm):
        if dec is None or not dec.split(d):
            lo.append(0)
            hi.append(_node_count(geom, l, d))
        else:
            b = dec.n[d]
            c = dec.of_rank(r).lo[d]
            lo.append(c)
            hi.append(c + b + 1)
    return tuple(lo), tuple(hi)


def _node_owned(geom: MLGeom, l, r):
    """The held nodes that rank r alone contributes to a sum, or None (a
    copy of a replicated axis that another rank contributes)."""
    dec = geom.decs[l]
    lo, hi = _node_held(geom, l, r)
    if dec is None:
        return lo, hi
    rd = dec.of_rank(r)
    if not rd.primary:
        return None
    hi = list(hi)
    for d in range(geom.dm):
        if dec.split(d) and (rd.internal(d, 1)
                             or geom.pmask_level(l)[d]):
            hi[d] -= 1
    return lo, tuple(hi)


def _parent_nodes(geom: MLGeom, c, box):
    """A box of child ``c``'s even nodes (child node index) as the
    coincident parent nodes (parent node index)."""
    child, pspec = geom.specs[c], geom.specs[geom.parent[c]]
    return (tuple((child.lo[d] + box[0][d]) // 2 - pspec.lo[d]
                  for d in range(geom.dm)),
            tuple((child.lo[d] + box[1][d] - 1) // 2 + 1 - pspec.lo[d]
                  for d in range(geom.dm)))


def fold_nodes(geom: MLGeom, c, res_p, res_c):
    """res_p (parent nodes) += P^T res_c over child ``c``'s lattice, the
    interface ring included (in place): each rank restricts its block
    (grown by two nodes from its neighbours) and adds the coarse nodes it
    owns into the parent's blocks."""
    dm = geom.dm
    dec = geom.decs[c]
    pm = geom.bpmask(c)
    if dec is None or not any(dec.split(d) for d in range(dm)):
        crs = ck.node_restrict(res_c, pm, dm)
    else:
        sh = [True] * dm
        crs = halo.crop(ck.node_restrict(halo.extend(res_c, dec, 2, sh),
                                         pm, dm), dec, 1)

    def box_of(r):
        own = _node_owned(geom, c, r)
        return None if own is None else _parent_nodes(geom, c, own)

    me = box_of(pmesh.rank())
    data = None
    if me is not None:
        held = _node_held(geom, c, pmesh.rank())[0]
        own = _node_owned(geom, c, pmesh.rank())
        data = crs[tuple(slice((o - h) // 2, (o - h) // 2 + (e - o + 1) // 2)
                         for o, e, h in zip(own[0], own[1], held))]
    return halo.put(res_p, geom.decs[geom.parent[c]], box_of, data,
                    add=True, kind="node")


def _prolong_window(geom: MLGeom, lev, r, d=None, side=None):
    """The parent nodes (lo, hi) whose nodal prolongation covers rank r's
    held nodes of ``lev`` (with ``d``/``side``: only the face plane there;
    None where the block does not reach that coarse-fine face)."""
    dm = geom.dm
    spec, pspec = geom.specs[lev], geom.specs[geom.parent[lev]]
    lo, hi = _node_held(geom, lev, r)
    if d is not None:
        dec = geom.decs[lev]
        if dec is not None and dec.of_rank(r).internal(d, side):
            return None
        f = 0 if side == 0 else spec.n[d]
        lo, hi = list(lo), list(hi)
        lo[d], hi[d] = f, f + 1
    return (tuple((spec.lo[t] + lo[t]) // 2 - pspec.lo[t] for t in range(dm)),
            tuple(-(-(spec.lo[t] + hi[t] - 1) // 2) + 1 - pspec.lo[t]
                  for t in range(dm)))


def _prolonged(geom: MLGeom, lev, phi_c, d=None, side=None):
    """The parent's nodal ``phi_c`` prolonged onto rank's held nodes of
    ``lev`` (or their face plane (d, side)); None where there are none."""
    dm = geom.dm
    par = geom.parent[lev]
    w = halo.fetch(phi_c, geom.decs[par],
                   lambda r: _prolong_window(geom, lev, r, d, side),
                   kind="node", wrap=tuple(geom.pmask_level(par)))
    if w is None:
        return None
    up = prolong_nodes(w, dm)
    lo, hi = _node_held(geom, lev, pmesh.rank())
    if d is not None:
        lo, hi = list(lo), list(hi)
        f = 0 if side == 0 else geom.specs[lev].n[d]
        lo[d], hi[d] = f, f + 1
    spec = geom.specs[lev]
    sl = tuple(slice((spec.lo[t] + lo[t]) % 2,
                     (spec.lo[t] + lo[t]) % 2 + hi[t] - lo[t])
               for t in range(dm))
    return up[sl]


def _set_interfaces_level(geom: MLGeom, lev, phi_f, phi_c):
    """Write the parent-interpolated values (linear along the interface)
    onto the cf faces of node ``lev`` that the block reaches (in place)."""
    for d in range(geom.dm):
        for side in range(2):
            if geom.side_kind(lev, d, side) != "cf":
                continue
            v = _prolonged(geom, lev, phi_c, d, side)
            if v is None:
                continue
            edge = slice(0, 1) if side == 0 else slice(-1, None)
            phi_f[_sl(geom.dm, d, edge)] = v
    return phi_f


def _prolong_node_patch(geom: MLGeom, lev, dc):
    """Prolong a parent nodal correction onto node ``lev``'s lattice (the
    rank's block of it)."""
    return _prolonged(geom, lev, dc)


def fine_nodal_mask(geom: MLGeom, lev):
    """1 = solve, 0 = fixed: the cf boundary nodes and any physical
    Dirichlet (outlet) node (on the block: its sides on the patch's
    boundary)."""
    dm = geom.dm
    sim = geom.sim
    ns = tuple(h - l for l, h in zip(*_node_held(geom, lev, pmesh.rank())))
    mask = torch.ones(ns, dtype=sim.dtype, device=sim.device)
    for d in range(dm):
        for side in range(2):
            kind = geom.bkind(lev, d, side)
            if kind == "cf" or (kind == "phys"
                                and sim.phys_bc[d][side] == OUTLET):
                edge = slice(0, 1) if side == 0 else slice(-1, None)
                mask[_sl(dm, d, edge)] = 0.0
    return mask


def base_nodal_mask(geom: MLGeom):
    """Sim.nodal_mask on the base level's block: 0 on OUTLET boundary
    nodes, None where the domain has no outlet."""
    if not any(OUTLET in pair for pair in geom.sim.phys_bc):
        return None
    return fine_nodal_mask(geom, 0)


def _slave_box(geom: MLGeom, c, r):
    """Rank r's even child nodes (child node index) that slave parent
    nodes: the held nodes without the interface ring."""
    lo, hi = _node_held(geom, c, r)
    lo, hi = list(lo), list(hi)
    for d in range(geom.dm):
        n = _node_count(geom, c, d)
        if geom.side_kind(c, d, 0) == "cf":
            lo[d] = max(lo[d], 2)
        if geom.side_kind(c, d, 1) == "cf":
            hi[d] = min(hi[d], n - 1)
        lo[d] += lo[d] % 2
        if hi[d] <= lo[d]:
            return None
    return tuple(lo), tuple(hi)


def slave_nodes(geom: MLGeom, c, phi_p, phi_c):
    """Parent nodes coincident with child ``c``'s lattice (not its
    interface ring) take the child's values (in place)."""
    box = _slave_box(geom, c, pmesh.rank())
    data = None
    if box is not None:
        held = _node_held(geom, c, pmesh.rank())[0]
        data = phi_c[tuple(slice(l - h, e - h, 2)
                           for l, e, h in zip(box[0], box[1], held))]

    def box_of(r):
        b = _slave_box(geom, c, r)
        return None if b is None else _parent_nodes(geom, c, b)

    return halo.put(phi_p, geom.decs[geom.parent[c]], box_of, data,
                    kind="node")


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
    pmask_l = [geom.bpmask(l) for l in range(nlev)]
    dec0 = geom.decs[0]
    if inflow_pad_l is None:
        inflow_pad_l = [None] * nlev
    rhs_l = [nodal.divu_rhs(vel_l[l], geom.dx(l), pmask_l[l], dm,
                            inflow_pad=inflow_pad_l[l], dec=geom.decs[l])
             for l in range(nlev)]
    mask0 = base_nodal_mask(geom)
    if nlev == 1:
        phi, info = nodal.solve(geom.bn(0), geom.dx(0), pmask_l[0],
                                sigma_l[0], rhs_l[0], mask=mask0,
                                phi0=None if phi0_l is None else phi0_l[0],
                                rel_eps=rel_eps, return_info=return_info,
                                dec=dec0)
        return [phi], info

    masks = [mask0] + [fine_nodal_mask(geom, l) for l in range(1, nlev)]
    singular = mask0 is None

    # sigma folded coarse-ward (the composite coefficient of the correction
    # hierarchies) and the uncovered-only coefficient / velocity
    sig_t = list(sigma_l)
    for c in range(nlev - 1, 0, -1):
        p = geom.parent[c]
        if sig_t[p] is sigma_l[p]:
            sig_t[p] = sig_t[p].clone()
        put_into_parent(geom, c, sig_t[p], restrict_cells(sig_t[c], dm))
    lev_uncov, rhs_uncov = [None] * nlev, [None] * nlev
    # A fine level that fixes no node (it covers the domain and has no
    # outlet side) has the constants as its correction problem's null
    # space, as a singular base level has: its hierarchy regularises them
    # (mask None). With a mask of ones the dense bottom operator is
    # singular and its inverse is roundoff-sized noise of order 1e15.
    hmask = [None if m is not None and not bool(level_max(
        geom, (m == 0).any().to(m.dtype))) else m for m in masks]
    hiers = [nodal.build_hierarchy(list(geom.bn(l)), list(geom.dx(l)),
                                   pmask_l[l], sig_t[l], hmask[l],
                                   dec=geom.sdec(l))
             for l in range(nlev)]

    def apply_level(l, sigma, diag):
        """An unmasked apply level with coefficient ``sigma``."""
        if geom.sdec(l) is not None:
            return nodal.make_dlevel(geom.bn(l), geom.dx(l), pmask_l[l],
                                     sigma, None, geom.sdec(l))
        return nodal.NodalLevel(tuple(geom.bn(l)), tuple(geom.dx(l)),
                                tuple(pmask_l[l]), sigma, diag, None)

    # unmasked-apply levels: the true per-level coefficients for residuals
    lev_true = [apply_level(l, sigma_l[l], hiers[l][0].diag)
                for l in range(nlev)]
    for l in range(nlev):
        if not geom.children[l]:
            continue
        su, vu = sigma_l[l].clone(), vel_l[l].clone()
        keep = torch.ones_like(su)
        for c in geom.children[l]:
            cov = covered_block(geom, c)
            if cov is None:
                continue
            su[cov] = 0.0
            vu[(slice(None),) + cov] = 0.0
            keep[cov] = 0.0
        lev_uncov[l] = apply_level(l, su, hiers[l][0].diag)
        # an inlet face's ghost velocity beside a covered cell belongs to
        # the child's rows, which take it through their own inflow pad
        # (varden_tpu counts it in both: ROADMAP.md section 3)
        rhs_uncov[l] = nodal.divu_rhs(vu, geom.dx(l), pmask_l[l], dm,
                                      inflow_pad=inflow_pad_l[l], keep=keep,
                                      dec=geom.decs[l])
        del vu

    if phi0_l is None:
        phis = [torch.zeros(tuple(h - l for l, h in zip(
            *_node_held(geom, lv, pmesh.rank()))), dtype=sim.dtype,
            device=sim.device) for lv in range(nlev)]
    else:
        phis = [p.clone() for p in phi0_l]

    def set_interfaces(phis):
        for l in range(1, nlev):
            _set_interfaces_level(geom, l, phis[l], phis[geom.parent[l]])
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
                fold_nodes(geom, c, r_own, res[c])
            res[l] = r_own
        return res

    def level_norms(res):
        r0 = res[0] if masks[0] is None else res[0] * masks[0]
        r0 = r0 - nodal._gmean(r0, dec0, dm) if singular else r0
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
            fold_nodes(geom, l, res[p],
                       -nodal.nd_apply_raw(hiers[l][0], d[l]))
        r0 = res[0]
        if singular:
            r0 = r0 - nodal._gmean(r0, dec0, dm)
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
            slave_nodes(geom, c, phis[geom.parent[c]], phis[c])
        return phis

    tol = rel_eps * float(_max_abs(geom, rhs_l))
    diag_max = float(_max_abs(geom, [h[0].diag for h in hiers]))
    phis = set_interfaces(phis)
    res = comp_residuals(phis)
    norms_t = level_norms(res)
    iters = 0
    norms, tol_h, floor = _reduced_stop_test(geom, norms_t, tol, diag_max,
                                             phis)
    while iters < MAX_OUTER and max(norms) > tol_h:
        d = comp_correction(res)
        phis = [p + di for p, di in zip(phis, d)]
        del d
        phis = slave(set_interfaces(phis))
        if singular:
            m = nodal._gmean(phis[0], dec0, dm)
            phis = [p - m for p in phis]
        res = comp_residuals(phis)
        norms_t = level_norms(res)
        iters += 1
        norms, tol_h, floor = _reduced_stop_test(geom, norms_t, tol,
                                                 diag_max, phis)
    _trace("nodal", iters, tol, floor, norms)
    rn = level_max(geom, torch.stack(norms_t).max())
    phis = set_interfaces(phis)
    if return_info:
        tiny = torch.finfo(rn.dtype).tiny
        return phis, (rn, iters, rn / max(tol_h, tiny))
    return phis, rn
