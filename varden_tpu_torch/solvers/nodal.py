"""Node-centered variable-coefficient Poisson multigrid, the "hg" solver
(counterpart of varden_tpu.solvers.nodal).

FBoxLib's ml_nd_solve + ND_DENSE nodal stencil as consumed by the
reference's hg_multigrid wrapper (src/hg_multigrid.f90:95-105): solves the
weak-form system A(sigma) phi = b(u) with trilinear nodal basis functions
and cell-wise constant sigma = 1/rho. Periodic axes wrap (n nodes); Neumann
(walls/inflow) is natural (sigma zero-extended); Dirichlet (outflow) masks
boundary nodes to 0. Multigrid: weighted-Jacobi smoothing, P^T restriction,
linear prolongation and a bottom solve that is dense and direct by default,
or smoothing sweeps, CG or BiCGStab (hg_bottom_solver, see
mg.BOTTOM_METHODS).

In 3-D every operator application of the V-cycle, the smoothing and the
residuals run through the nodal_sweep_3d kernel (ops/cuda_kernels.py): on
an unmasked level a V-cycle's visit is two of its fused passes, the
pre-smooth with the residual and the restriction, and the prolongation with
the post-smooth, on the unpadded node tensor; masked levels apply the
operator and update outside it. The dense bottom matrix is assembled once
per hierarchy by the plain factored apply. In 2-D, where varden_tpu has no
nodal kernel either, they all run through the plain factored apply.

Spans and counters (profiling), as in solvers/mg: ``vcycles.nodal`` and
``nodal::vcycle`` for a V-cycle entered at the finest level,
``nodal::coarse`` from its first level of at most
mg.CONST_FUSED_MAX_CELLS nodes down, and ``solve``'s ``nodal::build`` and
``nodal::converge``; host reads at the sites ``nodal.*``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import profiling
from ..ops import cuda_kernels as ck
from ..parallel import halo
from . import mg as _mg

JACOBI_OMEGA = 0.85
DEFAULT_NU1 = 2
DEFAULT_NU2 = 2
DEFAULT_MAX_CYCLES = 100  # hg_multigrid.f90:66
BOTTOM_SIZE = 8


def _sl(ndim, axis, s):
    out = [slice(None)] * ndim
    out[axis] = s
    return tuple(out)


def element_matrix(dx: Sequence[float]) -> np.ndarray:
    """FEM element stiffness for a d-linear element, K[(i...),(j...)] with
    local node multi-indices in {0,1}^dm."""
    dm = len(dx)
    S = [np.array([[1.0, -1.0], [-1.0, 1.0]]) / h for h in dx]
    M = [np.array([[2.0, 1.0], [1.0, 2.0]]) * (h / 6.0) for h in dx]
    K = np.zeros((2,) * dm * 2)
    for d in range(dm):
        mats = [S[t] if t == d else M[t] for t in range(dm)]
        term = mats[0]
        for m in mats[1:]:
            term = np.multiply.outer(term, m)
        perm = [2 * t for t in range(dm)] + [2 * t + 1 for t in range(dm)]
        K += np.transpose(term, perm)
    return K


def _pad_cell(f, pmask, dm, fill=0.0, dec=None):
    """Pad a cell tensor with one ghost per axis: wrap if periodic else fill
    (the neighbour's cells on a decomposed block's internal faces)."""
    for d in range(dm):
        axis = f.ndim - dm + d
        lo_x, hi_x = (None, None) if dec is None else \
            halo.exchange(f, dec, d, 1, 1)
        if pmask[d]:
            lo, hi = f[_sl(f.ndim, axis, slice(-1, None))], \
                f[_sl(f.ndim, axis, slice(0, 1))]
        else:
            lo = torch.full_like(f[_sl(f.ndim, axis, slice(0, 1))], fill)
            hi = lo.clone()
        f = torch.cat([lo if lo_x is None else lo_x, f,
                       hi if hi_x is None else hi_x], dim=axis)
    return f


@dataclasses.dataclass(frozen=True)
class NodalLevel:
    n: Tuple[int, ...]            # cells per axis
    dx: Tuple[float, ...]
    pmask: Tuple[bool, ...]
    sigma: torch.Tensor           # cell coefficient (1/rho)
    diag: torch.Tensor            # operator diagonal on nodes
    mask: Optional[torch.Tensor]  # 1 = solve, 0 = Dirichlet(0) node; None
    binv: Optional[torch.Tensor] = None  # bottom level only
    # the smoother's 1/diag and the shifted-padded sigma, formed once per
    # level by build_hierarchy (None: formed at each use)
    inv_diag: Optional[torch.Tensor] = None
    sig_np: Optional[torch.Tensor] = None
    # a level decomposed over ranks (see make_dlevel): the rank's block
    # (parallel.mesh.Decomp; pmask the block's, the split axes not
    # periodic) and the level on the block grown by one cell
    dec: Optional[object] = None
    ext: Optional["NodalLevel"] = None

    @property
    def dm(self):
        return len(self.n)


def _factored_apply(phi, sigma, dx, pmask, dm):
    """FEM stencil apply in factored form (leading batch axes broadcast):
    A phi = sum_d D_d^T [ sigma * (m_t1 x m_t2)(D_d phi) ]."""
    nd = phi.ndim
    ax = [nd - dm + d for d in range(dm)]
    out = None
    for d in range(dm):
        tangs = [t for t in range(dm) if t != d]
        if pmask[d]:
            g = torch.roll(phi, -1, dims=ax[d]) - phi
        else:
            n = phi.shape[ax[d]]
            g = phi.narrow(ax[d], 1, n - 1) - phi.narrow(ax[d], 0, n - 1)

        def corner(q):
            v = g
            for qi, t in zip(q, tangs):
                n_t = v.shape[ax[t]]
                if not pmask[t]:
                    v = v.narrow(ax[t], qi, n_t - 1)
                elif qi == 1:
                    v = torch.roll(v, -1, dims=ax[t])
            return v

        corners = {q: corner(q) for q in itertools.product((0, 1), repeat=dm - 1)}
        for ti in range(dm - 1):
            new = {}
            for q in corners:
                flip = tuple(1 - qq if i == ti else qq
                             for i, qq in enumerate(q))
                new[q] = 2.0 * corners[q] + corners[flip]
            corners = new
        scale = 1.0 / dx[d]
        for t in tangs:
            scale = scale * (dx[t] / 6.0)
        r = None
        for q, w in corners.items():
            w = (scale * sigma) * w
            # scatter: node j receives w from cell j - q along tangential axes
            for qi, t in zip(q, tangs):
                if pmask[t]:
                    if qi == 1:
                        w = torch.roll(w, 1, dims=ax[t])
                else:
                    z = torch.zeros_like(w.narrow(ax[t], 0, 1))
                    w = torch.cat([z, w] if qi == 1 else [w, z], dim=ax[t])
            r = w if r is None else r + w
        if pmask[d]:
            contrib = torch.roll(r, 1, dims=ax[d]) - r
        else:
            z = torch.zeros_like(r.narrow(ax[d], 0, 1))
            contrib = torch.cat([z, r], dim=ax[d]) - torch.cat([r, z], dim=ax[d])
        out = contrib if out is None else out + contrib
    return out


def _kernel_nodal(level: NodalLevel, phi, rhs, emit):
    """One nodal_sweep_3d pass (apply / residual) on a level."""
    sig_np = level.sig_np
    if sig_np is None:
        sig_np = ck.node_sigma_np(level.sigma, level.pmask, level.dm)
    return ck.nodal_sweep_3d(ck.node_pad(phi, level.pmask, level.dm), sig_np,
                             rhs, None, level.dx, emit=emit)


def _inv_diag(level):
    if level.inv_diag is not None:
        return level.inv_diag
    d = level.diag
    return torch.where(d > 0, 1.0 / torch.where(d == 0, torch.ones_like(d), d),
                       torch.zeros_like(d))


def _fused_route(level: NodalLevel) -> bool:
    """Whether the level smooths through kernel 4's fused stages (unmasked
    3-D levels; the masked fine levels of the composite solve take the
    apply with the update outside)."""
    return level.mask is None and level.dm == 3


def _fused(level: NodalLevel, phi, rhs, emit, nsweeps, corr=None,
           omega=JACOBI_OMEGA):
    """One of kernel 4's fused stages (smooth / smooth_restrict)."""
    return ck.nodal_sweep_3d(phi, level.sigma, rhs, _inv_diag(level),
                             level.dx, omega, emit, pmask=level.pmask,
                             nsweeps=nsweeps, corr=corr)


def nd_apply_raw(level: NodalLevel, phi):
    """The operator apply WITHOUT the mask: the composite solves, whose
    boundary nodes carry inhomogeneous (coarse-interpolated) values. In 3-D
    the kernel's apply emit. On a decomposed level (make_dlevel) the apply
    runs on the block grown by one cell and node."""
    if level.dec is not None:
        return halo.crop(nd_apply_raw(level.ext, _grow(level, phi)),
                         level.dec, 1)
    if level.dm == 3:
        return _kernel_nodal(level, phi, None, "apply")
    return _factored_apply(phi, level.sigma, level.dx, level.pmask, level.dm)


def nd_apply(level: NodalLevel, phi):
    if level.mask is not None:
        phi = phi * level.mask
    if level.dm == 3:
        out = _kernel_nodal(level, phi, None, "apply")
    else:
        out = _factored_apply(phi, level.sigma, level.dx, level.pmask,
                              level.dm)
    if level.mask is not None:
        out = out * level.mask
    return out


def node_diag(sigma, dx, pmask, dm, dec=None):
    """Operator diagonal: diag = c0 * (sum of sigma over adjacent cells)."""
    c0 = 0.0
    for d in range(dm):
        term = 1.0 / dx[d]
        for t in range(dm):
            if t != d:
                term *= dx[t] / 3.0
        c0 += term
    sp = _pad_cell(sigma, pmask, dm, dec=dec)
    ns = node_shape(tuple(sigma.shape[sigma.ndim - dm + d] for d in range(dm)),
                    pmask)
    acc = None
    for c in itertools.product((-1, 0), repeat=dm):
        sl = [slice(None)] * sp.ndim
        for d in range(dm):
            start = c[d] + 1
            sl[sp.ndim - dm + d] = slice(start, start + ns[d])
        term = sp[tuple(sl)]
        acc = term if acc is None else acc + term
    return c0 * acc


def jacobi(level: NodalLevel, phi, rhs, nsweeps, omega=JACOBI_OMEGA):
    """Weighted-Jacobi sweeps: kernel 4's fused smooth emit (nsweeps sweeps
    a launch pair), or (masked levels, and 2-D) the operator apply with the
    update outside."""
    if level.dec is not None:
        return _djacobi(level, phi, rhs, nsweeps, omega)
    if _fused_route(level):
        return _fused(level, phi, rhs, "smooth", nsweeps, omega=omega)
    inv = _inv_diag(level)
    for _ in range(nsweeps):
        r = rhs - nd_apply(level, phi)
        upd = omega * r * inv
        phi = phi + (upd if level.mask is None else upd * level.mask)
    return phi


def _residual(level: NodalLevel, phi, rhs):
    if level.dec is not None:
        return _dresidual(level, phi, rhs)
    if level.mask is None and level.dm == 3:
        return _kernel_nodal(level, phi, rhs, "residual")
    return rhs - nd_apply(level, phi)


def _coarsen_mask(mask, pmask, dm):
    if mask is None:
        return None
    for d in range(dm):
        mask = mask[_sl(mask.ndim, mask.ndim - dm + d, slice(0, None, 2))]
    return mask


def _cell_avg(f, dm):
    for d in range(dm):
        ax = f.ndim - dm + d
        f = 0.5 * (f[_sl(f.ndim, ax, slice(0, None, 2))]
                   + f[_sl(f.ndim, ax, slice(1, None, 2))])
    return f


def build_hierarchy(n, dx, pmask, sigma, mask,
                    bottom: str = "dense", dec=None,
                    top: NodalLevel = None) -> List[NodalLevel]:
    """The level stack by factor-2 coarsening, finest first, with the dense
    bottom's inverse; with ``dec`` the finest levels are decomposed over
    the ranks (see _dbuild; ``top``: the finest one, already built)."""
    if dec is not None:
        return _dbuild(n, dx, pmask, sigma, mask, bottom, dec, top)
    dm = len(n)
    levels = []
    n = list(n)
    dx = list(dx)
    while True:
        diag = node_diag(sigma, dx, pmask, dm)
        lev = NodalLevel(tuple(n), tuple(dx), tuple(pmask), sigma, diag, mask)
        levels.append(dataclasses.replace(
            lev, inv_diag=_inv_diag(lev),
            sig_np=ck.node_sigma_np(sigma, pmask, dm) if dm == 3 else None))
        if any(s % 2 != 0 or s <= BOTTOM_SIZE for s in n):
            break
        n = [s // 2 for s in n]
        dx = [2.0 * h for h in dx]
        sigma = _cell_avg(sigma, dm)
        mask = _coarsen_mask(mask, pmask, dm)
    lb = levels[-1]
    N = 1
    for s in node_shape(lb.n, pmask):
        N *= s
    if bottom == "dense" and N <= 4096:
        A = _bottom_dense_A(lb)
        eye = torch.eye(N, dtype=A.dtype, device=A.device)
        with profiling.library_read("nodal.build"):
            binv = torch.linalg.solve(A, eye)
        levels[-1] = dataclasses.replace(lb, binv=binv)
    return levels


def node_shape(n, pmask):
    return tuple(nd if p else nd + 1 for nd, p in zip(n, pmask))


def _bottom_dense_A(level: NodalLevel):
    """The (tiny) coarsest nodal operator, by the plain factored apply on
    the identity: rank-1 regularized (no mask: null space = constants) or
    with identity rows on Dirichlet nodes."""
    shape = node_shape(level.n, level.pmask)
    N = 1
    for s in shape:
        N *= s
    dtype, dev = level.diag.dtype, level.diag.device
    eye = torch.eye(N, dtype=dtype, device=dev).reshape((N,) + shape)
    if level.mask is not None:
        eye = eye * level.mask
    cols = _factored_apply(eye, level.sigma, level.dx, level.pmask, level.dm)
    if level.mask is not None:
        cols = cols * level.mask
    A = cols.reshape(N, N).T
    if level.mask is None:
        A = A + 1.0 / N
    else:
        A = A + torch.diag(1.0 - level.mask.reshape(-1))
    return A


def bottom_solve(level: NodalLevel, r, method: str = "dense"):
    """Bottom-solver dispatch honoring the reference's hg_bottom_solver
    codes (see mg.BOTTOM_METHODS): dense direct (default), smoothing
    sweeps, or matrix-free CG/BiCGStab at bottom_solver_eps=1e-3."""
    if method == "dense":
        return bottom_dense_solve(level, r)
    if method == "smoother":
        return jacobi(level, torch.zeros_like(r), r, 10)

    def apply_fn(x):
        if level.mask is None:
            # the dense path's rank-1 regularization along the constant
            # null space: A + J/N is SPD on the mean-free complement
            return nd_apply(level, x) + x.mean()
        return nd_apply(level, x) * level.mask

    r = r - r.mean() if level.mask is None else r * level.mask
    out = _mg._krylov_bottom(apply_fn, r, tuple(range(r.ndim)), method)
    if level.mask is not None:
        out = out * level.mask
    return out


def bottom_dense_solve(level: NodalLevel, r):
    """Direct dense bottom solve (one matvec with the precomputed inverse)."""
    shape = r.shape
    if level.mask is None:
        r = r - r.mean()
    else:
        r = r * level.mask
    if level.binv is not None:
        out = (level.binv @ r.reshape(-1)).reshape(shape)
    else:
        with profiling.library_read("nodal.bottom"):
            out = torch.linalg.solve(_bottom_dense_A(level),
                                     r.reshape(-1)).reshape(shape)
    if level.mask is not None:
        out = out * level.mask
    return out


def _nodes(level) -> int:
    return math.prod(node_shape(level.n, level.pmask))


_VCYCLES = profiling.counter("vcycles.nodal")


def v_cycle(levels, phi, rhs, lev=0, nu1=DEFAULT_NU1, nu2=DEFAULT_NU2,
            return_resnorm=False, bottom="dense"):
    """One V-cycle. With return_resnorm, also returns the max-norm of the
    post-pre-smooth fine residual (a 0-d tensor). Entered at the finest
    level it counts one ``vcycles.nodal`` and is the span
    ``nodal::vcycle``; its first level of at most mg.CONST_FUSED_MAX_CELLS
    nodes opens ``nodal::coarse``."""
    if lev == 0:
        _VCYCLES.count += 1
    with (profiling.span("nodal::vcycle") if lev == 0 else profiling.NULL), \
            (profiling.span("nodal::coarse")
             if _mg._coarse_top(levels, lev, _nodes) else profiling.NULL):
        return _visit(levels, phi, rhs, lev, nu1, nu2, return_resnorm,
                      bottom)


def _visit(levels, phi, rhs, lev, nu1, nu2, return_resnorm, bottom):
    """v_cycle's visit of ``levels[lev]``: the smoothing, the coarser
    levels' correction through v_cycle, or the bottom solve."""
    level = levels[lev]
    if level.dec is not None:
        return _dv_cycle(levels, phi, rhs, lev, nu1, nu2, return_resnorm,
                         bottom)
    if lev == len(levels) - 1:
        r = _residual(level, phi, rhs)
        out = phi + bottom_solve(level, r, bottom)
        return (out, r.abs().max()) if return_resnorm else out
    fused = _fused_route(level)
    if fused:
        # nu1 sweeps, the residual, its restriction and max|r|: one pass of
        # kernel 4
        phi, crs_rhs, rmax = _fused(level, phi, rhs, "smooth_restrict", nu1)
    else:
        phi = jacobi(level, phi, rhs, nu1)
        res = _residual(level, phi, rhs)
        crs_rhs = ck.node_restrict(res, level.pmask, level.dm)
        rmax = res.abs().max()
    nxt = levels[lev + 1]
    if nxt.mask is not None:
        crs_rhs = crs_rhs * nxt.mask
    corr = v_cycle(levels, torch.zeros_like(crs_rhs), crs_rhs, lev + 1, nu1,
                   nu2, bottom=bottom)
    if fused:
        # phi + the linear prolongation of corr, then nu2 sweeps: one pass
        phi = _fused(level, phi, rhs, "smooth", nu2, corr=corr)
        return (phi, rmax) if return_resnorm else phi
    corr_f = ck.node_prolong(corr, node_shape(level.n, level.pmask),
                             level.pmask, level.dm)
    if level.mask is not None:
        corr_f = corr_f * level.mask
    phi = jacobi(level, phi + corr_f, rhs, nu2)
    return (phi, rmax) if return_resnorm else phi


# ---------------------------------------------------------------------------
# Levels decomposed over ranks
# ---------------------------------------------------------------------------
# A rank holds the nodes of its block's closure: n + 1 along a split axis,
# the last one shared with the hi neighbour, which owns it (_owned). Both
# ranks compute a shared node from the same values, since each pass runs on
# the block grown by one cell and one node from the neighbours and keeps the
# block's nodes: a Jacobi sweep (kernel 4's single-sweep jacobi emit on an
# unmasked 3-D level, the apply with the update outside elsewhere) or a
# residual spoils only the outermost grown node. One exchange a sweep.


def _shared(dm):
    return [True] * dm


def make_dlevel(n, dx, pmask, sigma, mask, dec) -> NodalLevel:
    """A nodal level decomposed over ranks: ``n``, ``sigma`` and ``mask``
    the rank's block (``pmask`` the block's), with the grown level of its
    passes."""
    dm = len(n)
    lev = NodalLevel(tuple(n), tuple(dx), tuple(pmask), sigma,
                     node_diag(sigma, dx, pmask, dm, dec=dec), mask, dec=dec)
    sig_e = halo.extend(sigma, dec, 1)
    mask_e = None if mask is None else halo.extend(mask, dec, 1, _shared(dm))
    n_e = tuple(sig_e.shape[sig_e.ndim - dm:])
    ext = NodalLevel(n_e, tuple(dx), tuple(pmask), sig_e,
                     node_diag(sig_e, dx, pmask, dm), mask_e)
    ext = dataclasses.replace(
        ext, inv_diag=_inv_diag(ext),
        sig_np=ck.node_sigma_np(sig_e, pmask, dm) if dm == 3 else None)
    return dataclasses.replace(lev, inv_diag=_inv_diag(lev), ext=ext)


def _grow(level, f):
    return halo.extend(f, level.dec, 1, _shared(level.dm))


def _dresidual(level: NodalLevel, phi, rhs):
    return halo.crop(_residual(level.ext, _grow(level, phi),
                               _grow(level, rhs)), level.dec, 1)


def _djacobi(level: NodalLevel, phi, rhs, nsweeps, omega=JACOBI_OMEGA):
    e, dec = level.ext, level.dec
    rhs_e = _grow(level, rhs)
    for _ in range(nsweeps):
        phi_e = _grow(level, phi)
        if _fused_route(e):
            out = ck.nodal_sweep_3d(ck.node_pad(phi_e, e.pmask, 3), e.sig_np,
                                    rhs_e, e.inv_diag, e.dx, omega, "jacobi")
        else:
            out = jacobi(e, phi_e, rhs_e, 1, omega)
        phi = halo.crop(out, dec, 1)
    return phi


def node_extra(pmask):
    """Nodes past the cells per axis: 0 on a periodic axis, else 1."""
    return [0 if p else 1 for p in pmask]


def _owned(x, dec, dm):
    """The nodes this rank owns: a split axis drops the last node, which
    the hi neighbour owns, unless it is the level's physical end."""
    for d in range(dm):
        if dec.split(d) and dec.internal(d, 1):
            ax = x.ndim - dm + d
            x = x.narrow(ax, 0, x.shape[ax] - 1)
    return x


def _gmean(x, dec, dm):
    """The mean over the whole level's nodes."""
    if dec is None:
        return x.mean()
    count = math.prod(node_shape(dec.n_glob, dec.pmask))
    return halo.all_sum(_owned(x, dec, dm).sum()) / count


def _dbuild(n, dx, pmask, sigma, mask, bottom, dec, top):
    """The hierarchy of a decomposed nodal solve: blocks while the coarser
    level keeps them and is not the bottom, then the whole level gathered
    onto every rank and the rest as a one-rank solve builds it."""
    dm = len(n)
    levels = []

    def bottom_of(ng):
        return any(s % 2 != 0 or s <= BOTTOM_SIZE for s in ng)

    while True:
        if bottom_of(dec.n_glob) or dec.coarsen((2,) * dm) is None:
            raise NotImplementedError(
                f"a decomposed nodal level of {dec.n_glob} cells must "
                f"coarsen into the rank blocks {dec.n}")
        levels.append(top if top is not None and not levels else
                      make_dlevel(n, dx, pmask, sigma, mask, dec))
        cdec = dec.coarsen((2,) * dm)
        n = cdec.n
        dx = [2.0 * h for h in dx]
        sigma = _cell_avg(sigma, dm)
        mask = _coarsen_mask(mask, pmask, dm)
        if cdec.keeps_blocks() and not bottom_of(cdec.n_glob):
            dec = cdec
            continue
        sigma = halo.gather(sigma, cdec)
        if mask is not None:
            mask = halo.gather(mask, cdec, node_extra(pmask),
                               node_extra(cdec.pmask))
        return levels + build_hierarchy(list(cdec.n_glob), dx,
                                        list(cdec.pmask), sigma, mask,
                                        bottom=bottom)


def _dv_cycle(levels, phi, rhs, lev, nu1, nu2, return_resnorm, bottom):
    """v_cycle's visit of a decomposed level: nu1 sweeps, the residual and
    its restriction (on the block grown by two nodes, so that the coarse
    nodes of the block's closure come out whole), the coarser level's
    correction (gathered where that level is), its prolongation on the
    block and nu2 sweeps."""
    level = levels[lev]
    dec, dm = level.dec, level.dm
    phi = _djacobi(level, phi, rhs, nu1)
    res = _dresidual(level, phi, rhs)
    rmax = _mg._gmax(res, dec)
    crs = halo.crop(ck.node_restrict(halo.extend(res, dec, 2, _shared(dm)),
                                     level.pmask, dm), dec, 1)
    nxt = levels[lev + 1]
    cdec = None if nxt.dec is not None else dec.coarsen((2,) * dm)
    if cdec is not None:
        crs = halo.gather(crs, cdec, node_extra(level.pmask),
                          node_extra(cdec.pmask))
    if nxt.mask is not None:
        crs = crs * nxt.mask
    corr = v_cycle(levels, torch.zeros_like(crs), crs, lev + 1, nu1, nu2,
                   bottom=bottom)
    if cdec is not None:
        corr = cdec.block(corr, nodal=True)
    corr_f = ck.node_prolong(corr, node_shape(level.n, level.pmask),
                             level.pmask, dm)
    if level.mask is not None:
        corr_f = corr_f * level.mask
    phi = _djacobi(level, phi + corr_f, rhs, nu2)
    return (phi, rmax) if return_resnorm else phi


def divu_rhs(u, dx, pmask, dm, inflow_pad=None, dec=None, keep=None):
    """Weak-form divergence source b_i = sum_cells u_c · ∫_c ∇N_i.

    ``u``: (dm, *cells) interior velocity. ``inflow_pad``: optional function
    (comp, d, side) -> ghost value for EXT_DIR inflow faces; other physical
    ghosts are zero (walls via create_uvec zeroing, hgproject.f90:424-427).
    ``keep``: optional (*cells) 0/1 tensor; a physical face's ghost cell
    counts only beside a cell it keeps (the uncovered part of a composite
    row). With ``dec`` the ghosts of a block's internal faces are the
    neighbours' cells, and the result is the block's nodes.
    """
    comps = []
    for c in range(dm):
        f = u[c]
        k = keep
        for d in range(dm):
            axis = f.ndim - dm + d
            lo_x, hi_x = (None, None) if dec is None else \
                halo.exchange(f, dec, d, 1, 1)
            k_x = (None, None) if dec is None or k is None else \
                halo.exchange(k, dec, d, 1, 1)
            if lo_x is not None or hi_x is not None:
                edge = f[_sl(f.ndim, axis, slice(0, 1))]
                lo = lo_x if lo_x is not None else torch.full_like(
                    edge, 0.0 if inflow_pad is None else inflow_pad(c, d, 0))
                hi = hi_x if hi_x is not None else torch.full_like(
                    edge, 0.0 if inflow_pad is None else inflow_pad(c, d, 1))
                if k is not None and lo_x is None:
                    lo = lo * k[_sl(k.ndim, axis, slice(0, 1))]
                if k is not None and hi_x is None:
                    hi = hi * k[_sl(k.ndim, axis, slice(-1, None))]
            elif pmask[d]:
                lo = f[_sl(f.ndim, axis, slice(-1, None))]
                hi = f[_sl(f.ndim, axis, slice(0, 1))]
            else:
                edge = f[_sl(f.ndim, axis, slice(0, 1))]
                lo = torch.full_like(edge, 0.0 if inflow_pad is None
                                     else inflow_pad(c, d, 0))
                hi = torch.full_like(edge, 0.0 if inflow_pad is None
                                     else inflow_pad(c, d, 1))
                if k is not None:
                    lo = lo * k[_sl(k.ndim, axis, slice(0, 1))]
                    hi = hi * k[_sl(k.ndim, axis, slice(-1, None))]
            f = torch.cat([lo, f, hi], dim=axis)
            if k is not None:
                k = torch.cat([k[_sl(k.ndim, axis, slice(0, 1))]
                               if k_x[0] is None else k_x[0], k,
                               k[_sl(k.ndim, axis, slice(-1, None))]
                               if k_x[1] is None else k_x[1]], dim=axis)
        comps.append(f)

    rhs = None
    vol_fac = [np.prod([dx[t] / 2.0 for t in range(dm) if t != d])
               for d in range(dm)]
    ns = node_shape(tuple(u.shape[-dm:]), pmask)
    for d in range(dm):
        up = comps[d]
        acc = None
        for c in itertools.product((-1, 0), repeat=dm):
            sl = [slice(None)] * up.ndim
            for t in range(dm):
                start = c[t] + 1
                sl[up.ndim - dm + t] = slice(start, start + ns[t])
            sgn = 1.0 if c[d] == -1 else -1.0
            term = sgn * up[tuple(sl)]
            acc = term if acc is None else acc + term
        term = float(vol_fac[d]) * acc
        rhs = term if rhs is None else rhs + term
    return rhs


def cell_grad(phi, dx, pmask, dm):
    """Average nodal->cell gradient (reference mkgphi, hgproject.f90:517-577).
    Returns (dm, *cells)."""
    grads = []
    nshape = phi.shape[phi.ndim - dm:]
    for d in range(dm):
        acc = None
        for corner in itertools.product((0, 1), repeat=dm):
            out = phi
            for t in range(dm):
                o = corner[t]
                axis = out.ndim - dm + t
                if pmask[t]:
                    if o == 1:
                        out = torch.roll(out, -1, dims=axis)
                else:
                    out = out.narrow(axis, o, nshape[t] - 1)
            sgn = 1.0 if corner[d] == 1 else -1.0
            term = sgn * out
            acc = term if acc is None else acc + term
        grads.append(acc / (2.0 ** (dm - 1) * dx[d]))
    return torch.stack(grads)


def solve(n, dx, pmask, sigma, rhs, *, mask=None, phi0=None,
          rel_eps=1.0e-11, abs_eps=-1.0, max_cycles=DEFAULT_MAX_CYCLES,
          return_info=False, bottom="dense", dec=None):
    """Solve A(sigma) phi = rhs on the node lattice. Returns (phi, resnorm),
    or (phi, (resnorm, cycles, ratio)) with return_info.

    The tolerance loop of varden_tpu.solvers.nodal.solve: inner V-cycles
    while the in-cycle monitor falls below 0.7x its previous value, an outer
    loop that re-checks the true residual and stops when the inner loop
    ended above tolerance (stalled), and an effective tolerance that
    includes the dtype's floor 4 eps * max|diag| * max|phi|.

    With ``dec`` (parallel.mesh.Decomp) the solve is decomposed over the
    ranks: n, sigma, mask, rhs and phi0 are the rank's block (its closure's
    nodes), pmask the block's. The max norms are all-reduced (exact) and
    the singular means summed over the owned nodes of every rank."""
    dm = len(n)
    singular = mask is None
    if dec is None:
        L0 = NodalLevel(tuple(n), tuple(dx), tuple(pmask), sigma,
                        node_diag(sigma, dx, pmask, dm), mask)
    else:
        L0 = make_dlevel(n, dx, pmask, sigma, mask, dec)
    if mask is not None:
        rhs = rhs * mask
    if singular:
        rhs = rhs - _gmean(rhs, dec, dm)
    phi = torch.zeros_like(rhs) if phi0 is None else phi0
    dtype = rhs.dtype
    bnorm = _mg._gmax(rhs, dec)
    tol = torch.clamp(rel_eps * bnorm, min=0.0 if abs_eps < 0 else abs_eps)
    diag_max = _mg._gmax(L0.diag, dec)

    def tol_eff(p):
        floor = _mg.roundoff_floor(diag_max, _mg._gmax(p, dec), dtype)
        return profiling.read(torch.maximum(tol, floor), "nodal.tol")

    def above(r, p):
        return profiling.read(r, "nodal.resnorm") > tol_eff(p)

    rn = _mg._gmax(_residual(L0, phi, rhs), dec)
    iters = 0
    with profiling.span("nodal::converge"):
        cold = above(rn, phi)
    if cold:
        with profiling.span("nodal::build"):
            levels = build_hierarchy(list(n), list(dx), list(pmask), sigma,
                                     mask, bottom=bottom, dec=dec, top=L0)
        stalled = False
        while True:
            with profiling.span("nodal::converge"):
                if not (iters < max_cycles and above(rn, phi) and not stalled):
                    break
                tl = tol_eff(phi)
            phi, mon = v_cycle(levels, phi, rhs, return_resnorm=True,
                               bottom=bottom)
            iters += 1
            with profiling.span("nodal::converge"):
                mon, prev = profiling.read(mon, "nodal.monitor"), float("inf")
            while iters < max_cycles and mon > tl and mon < 0.7 * prev:
                phi, mon2 = v_cycle(levels, phi, rhs, return_resnorm=True,
                                    bottom=bottom)
                iters += 1
                with profiling.span("nodal::converge"):
                    mon, prev = profiling.read(mon2, "nodal.monitor"), mon
            with profiling.span("nodal::converge"):
                rn = _mg._gmax(_residual(levels[0], phi, rhs), dec)
            stalled = mon > tl
    if singular:
        phi = phi - _gmean(phi, dec, dm)
    if return_info:
        tiny = torch.finfo(dtype).tiny
        with profiling.span("nodal::converge"):
            ratio = rn / max(tol_eff(phi), tiny)
        return phi, (rn, iters, ratio)
    return phi, rn
