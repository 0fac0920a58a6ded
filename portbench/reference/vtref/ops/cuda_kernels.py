"""The smoothers' and operators' plain PyTorch versions (the port's
ops/cuda_kernels.py with every wrapper reduced to its plain version, on
any device): gsrb_var_sweep_3d, gsrb_const_sweep_3d, nodal_sweep_3d,
gsrb_sweep_2d and gsrb_sweep_3d with their emits, and the node helpers."""
from __future__ import annotations

import torch


# elliptic BC codes (bc.py BC_PER/NEU/DIR + mg.BC_GHOST)
_BC_PER, _BC_NEU, _BC_DIR, _BC_GHOST = 0, 1, 2, 3
_EMITS = ("sweep", "residual", "restrict", "smooth", "smooth_restrict")

# sweeps a fused launch takes at most (the kernel's halo grows with them)
FUSED_SWEEPS = 2


def _check_nsweeps(emit, nsweeps):
    """A fused stage runs at least one sweep."""
    if emit in ("smooth", "smooth_restrict") and nsweeps < 1:
        raise ValueError(f"{emit}: nsweeps must be >= 1, got {nsweeps}")


def _ghost_planes(p, axis, lo_bc, hi_bc, blo, bhi):
    """Boundary ghost planes of ``p`` along ``axis``: DIR quadratic
    face-value formula, NEU copy, PER wrap, GHOST zero."""
    n = p.shape[axis]
    first, last = p.narrow(axis, 0, 1), p.narrow(axis, n - 1, 1)
    if lo_bc == _BC_PER:
        lo = last
    elif lo_bc == _BC_NEU:
        lo = first
    elif lo_bc == _BC_GHOST:
        lo = torch.zeros_like(first)
    else:
        lo = (8.0 / 3.0) * blo - 2.0 * first + (1.0 / 3.0) * p.narrow(axis, 1, 1)
    if hi_bc == _BC_PER:
        hi = first
    elif hi_bc == _BC_NEU:
        hi = last
    elif hi_bc == _BC_GHOST:
        hi = torch.zeros_like(last)
    else:
        hi = (8.0 / 3.0) * bhi - 2.0 * last + (1.0 / 3.0) * p.narrow(axis, n - 2, 1)
    return lo, hi


def _lphi(phi, beta, dxi2, ell_bc, bvals, aco, alpha):
    """alpha*aco*phi - div(beta grad phi) with in-place BC ghosts, on a
    2-D or 3-D phi."""
    acc = None
    for d in range(phi.ndim):
        n = phi.shape[d]
        lo_g, hi_g = _ghost_planes(phi, d, ell_bc[d][0], ell_bc[d][1],
                                   bvals[d][0], bvals[d][1])
        pm = torch.cat([lo_g, phi.narrow(d, 0, n - 1)], dim=d)
        pp = torch.cat([phi.narrow(d, 1, n - 1), hi_g], dim=d)
        blo, bhi = beta[d].narrow(d, 0, n), beta[d].narrow(d, 1, n)
        term = dxi2[d] * (bhi * (pp - phi) - blo * (phi - pm))
        acc = term if acc is None else acc + term
    out = -acc
    if alpha != 0.0:
        out = out + alpha * aco * phi
    return out


def _avg_down(f, dm=3):
    """2^dm cell average over the trailing dm axes, x then y (then z)
    (mg._cell_avg_down order)."""
    for d in range(dm):
        ev = [slice(None)] * f.ndim
        od = [slice(None)] * f.ndim
        ax = f.ndim - dm + d
        ev[ax], od[ax] = slice(0, None, 2), slice(1, None, 2)
        f = 0.5 * (f[tuple(ev)] + f[tuple(od)])
    return f


def cell_prolong(corr, fac):
    """Piecewise-constant prolongation along the axes with factor 2 (the
    order of mg.v_cycle)."""
    for d, f in enumerate(fac):
        if f == 2:
            corr = corr.repeat_interleave(2, dim=corr.ndim - len(fac) + d)
    return corr


def gsrb_var_sweep_3d_plain(phi, rhs, inv_diag, beta, dx, ell_bc, bvals,
                            aco=None, alpha=0.0, *, emit="sweep", nsweeps=1,
                            corr=None, cfac=(2, 2, 2)):
    """The plain PyTorch version of gsrb_var_sweep_3d (and of gsrb_sweep_2d:
    the arithmetic is written on phi's own number of axes). The fused emits
    are the compositions of the single ones: phi + prolong(corr), then
    nsweeps sweeps (smooth); nsweeps sweeps, then the restrict emit
    (smooth_restrict)."""
    dxi2 = tuple(1.0 / (float(h) * float(h)) for h in dx)

    def L(p):
        return _lphi(p, beta, dxi2, ell_bc, bvals, aco, alpha)

    def sweep(p):
        idx = _colour_index(p.shape, p.device)
        for colour in (0, 1):
            upd = p + (rhs - L(p)) * inv_diag
            p = torch.where(idx % 2 == colour, upd, p)
        return p

    def restrict(p):
        r = rhs - L(p)
        return _avg_down(r, r.ndim), r.abs().max()

    if emit == "residual":
        return rhs - L(phi)
    if emit == "restrict":
        return restrict(phi)
    if emit == "sweep":
        return sweep(phi)
    if corr is not None:
        phi = phi + cell_prolong(corr, cfac)
    for _ in range(nsweeps):
        phi = sweep(phi)
    if emit == "smooth":
        return phi
    return (phi, *restrict(phi))


def gsrb_var_sweep_3d(phi, rhs, inv_diag, beta, dx, ell_bc, bvals,
                      aco=None, alpha=0.0, *, emit="sweep", nsweeps=1,
                      corr=None, cfac=(2, 2, 2)):
    """Variable-beta GSRB of L = alpha*aco*phi - div(beta grad phi): one
    exact red-black sweep (emit="sweep"), the residual rhs - L(phi), the
    residual's 2x2x2 average with max|r| ("restrict"), or a fused
    multigrid stage:

      "smooth"           phi + prolong(corr) (piecewise constant along the
                         axes whose cfac is 2; corr None adds nothing),
                         then nsweeps sweeps;
      "smooth_restrict"  nsweeps sweeps, then the restrict emit of the
                         result: returns (phi, coarse residual, max|r|).

    phi/rhs/inv_diag/aco: (n0, n1, n2); beta: three face tensors. "restrict"
    returns (coarse residual (n/2), max|r| as a 0-d tensor); "sweep",
    "residual" and "smooth" a tensor of phi's shape. inv_diag is read by the
    sweeps only, aco only when alpha != 0. On the card each emit is one
    launch (two for "sweep", one a colour; a fused emit takes two sweeps a
    launch)."""
    if emit not in _EMITS:
        raise ValueError(f"bad emit {emit!r}")
    _check_nsweeps(emit, nsweeps)
    return gsrb_var_sweep_3d_plain(phi, rhs, inv_diag, beta, dx, ell_bc,
                                   bvals, aco, alpha, emit=emit,
                                   nsweeps=nsweeps, corr=corr, cfac=cfac)


gsrb_var_sweep_3d.launches = 0
gsrb_var_sweep_3d.fused_launches = 0  # of them, the fused stages


# ---------------------------------------------------------------------------
# constant-coefficient Helmholtz, batched
# ---------------------------------------------------------------------------

_CONST_EMITS = ("sweep", "residual", "smooth", "smooth_restrict")


def _colour_index(n, device):
    """The sum of the cell indices over a grid (red cells: even)."""
    dm = len(n)
    return sum(torch.arange(n[d], device=device).reshape(
        [-1 if t == d else 1 for t in range(dm)]) for d in range(dm))


def _lphi_const(phi, coef, ell_bc, bvals, aco):
    """alpha*aco*phi - sum_d coef[d]*(phi[+1] + phi[-1] - 2 phi) on the
    trailing three axes of a (B, n0, n1, n2) tensor, BC ghosts built in
    place; aco None drops the alpha term."""
    acc = None
    for d in range(3):
        ax = d + 1
        n = phi.shape[ax]
        lo_g, hi_g = _ghost_planes(phi, ax, ell_bc[d][0], ell_bc[d][1],
                                   bvals[d][0], bvals[d][1])
        pm = torch.cat([lo_g, phi.narrow(ax, 0, n - 1)], dim=ax)
        pp = torch.cat([phi.narrow(ax, 1, n - 1), hi_g], dim=ax)
        term = coef[d] * (pp + pm - 2.0 * phi)
        acc = term if acc is None else acc + term
    out = -acc
    if aco is not None:
        out = out + coef[3] * aco * phi
    return out


def gsrb_const_sweep_3d_plain(phi, rhs, inv_diag, coef, ell_bc, bvals,
                              aco=None, *, emit="sweep", nsweeps=1,
                              corr=None, cfac=(2, 2, 2)):
    """The plain PyTorch version of gsrb_const_sweep_3d. The fused emits
    are the compositions of the single ones in mg.v_cycle's order: phi +
    prolong(corr), then nsweeps sweeps (smooth); nsweeps sweeps, then the
    residual, its 2x2x2 average and max|r| over the batch
    (smooth_restrict)."""
    coef = [float(c) for c in coef]
    bvals = [[float(v) for v in bv] for bv in bvals]

    def res(p):
        lp = _lphi_const(p, coef, ell_bc, bvals, aco)
        return -lp if rhs is None else rhs - lp

    def sweep(p):
        idx = _colour_index(p.shape[1:], p.device)
        for colour in (0, 1):
            upd = p + res(p) * inv_diag
            p = torch.where(idx % 2 == colour, upd, p)
        return p

    if emit == "residual":
        return res(phi)
    if emit == "sweep":
        return sweep(phi)
    if corr is not None:
        phi = phi + cell_prolong(corr, cfac)
    for _ in range(nsweeps):
        phi = sweep(phi)
    if emit == "smooth":
        return phi
    r = res(phi)
    return phi, _avg_down(r), r.abs().max()


def gsrb_const_sweep_3d(phi, rhs, inv_diag, coef, ell_bc, bvals, aco=None,
                        *, emit="sweep", nsweeps=1, corr=None,
                        cfac=(2, 2, 2)):
    """Batched constant-coefficient GSRB of (alpha*aco - beta lap) phi = rhs
    on fields that share the operator: one exact red-black sweep
    (emit="sweep"), the residual rhs - L(phi) (emit="residual"), or a fused
    multigrid stage:

      "smooth"           phi + prolong(corr) (piecewise constant along the
                         axes whose cfac is 2; corr None adds nothing),
                         then nsweeps sweeps;
      "smooth_restrict"  nsweeps sweeps, then the residual's 2x2x2 average
                         and max|r| over the whole batch: returns (phi,
                         coarse residual, max|r| as a 0-d tensor).

    phi/rhs: (B, n0, n1, n2), a leading batch axis is required (phi[None]
    for one field); corr (B, n0/f0, n1/f1, n2/f2); inv_diag/aco: (n0, n1,
    n2), shared over the batch; coef: [beta/dx0^2, beta/dx1^2, beta/dx2^2,
    alpha] as host numbers. aco None drops the alpha term. rhs None means
    zero (residual only); inv_diag is read by the sweeps only. On the card
    "sweep" is two launches (one a colour), "residual" one, and a fused
    emit one launch for every FUSED_SWEEPS sweeps."""
    if emit not in _CONST_EMITS:
        raise ValueError(f"bad emit {emit!r}")
    _check_nsweeps(emit, nsweeps)
    if phi.ndim != 4:
        raise ValueError("gsrb_const_sweep_3d: phi must be (B, n0, n1, n2), "
                         f"got {tuple(phi.shape)}")
    if len(coef) != 4:
        raise ValueError(f"coef must have 4 entries, got {len(coef)}")
    if rhs is None and emit != "residual":
        raise ValueError("rhs=None (zero) is for emit='residual' only")
    return gsrb_const_sweep_3d_plain(phi, rhs, inv_diag, coef, ell_bc,
                                     bvals, aco, emit=emit,
                                     nsweeps=nsweeps, corr=corr,
                                     cfac=cfac)


gsrb_const_sweep_3d.launches = 0
gsrb_const_sweep_3d.fused_launches = 0  # of them, the fused stages


# ---------------------------------------------------------------------------
# nodal
# ---------------------------------------------------------------------------

_NODAL_EMITS = ("apply", "residual", "jacobi", "smooth", "smooth_restrict")


def _nsl(ndim, axis, s):
    out = [slice(None)] * ndim
    out[axis] = s
    return tuple(out)


def node_shift(phi, offset, pmask, dm):
    """phi[i+offset] on the node lattice: wrap on periodic axes, zero-extend
    on physical axes."""
    out = phi
    for d in range(dm):
        o = offset[d]
        if o == 0:
            continue
        axis = out.ndim - dm + d
        if pmask[d]:
            out = torch.roll(out, -o, dims=axis)
        else:
            n = out.shape[axis]
            zero = torch.zeros_like(out.narrow(axis, 0, 1))
            if o == 1:
                out = torch.cat([out.narrow(axis, 1, n - 1), zero], dim=axis)
            else:
                out = torch.cat([zero, out.narrow(axis, 0, n - 1)], dim=axis)
    return out


def node_pad(phi, pmask, dm):
    """Pad a node tensor with one ghost per axis: periodic wrap, else zero
    (physical-side coefficients are exactly zero, so the value is unread)."""
    for d in range(dm):
        axis = phi.ndim - dm + d
        if pmask[d]:
            lo = phi[_nsl(phi.ndim, axis, slice(-1, None))]
            hi = phi[_nsl(phi.ndim, axis, slice(0, 1))]
        else:
            lo = torch.zeros_like(phi[_nsl(phi.ndim, axis, slice(0, 1))])
            hi = lo
        phi = torch.cat([lo, phi, hi], dim=axis)
    return phi


def node_sigma_np(sigma, pmask, dm):
    """Shifted-padded cell sigma: out[k] = sigma_cell[k-1] over the node
    range (N+1 entries per axis), wrapping on periodic axes, zero outside."""
    for d in range(dm):
        axis = sigma.ndim - dm + d
        if pmask[d]:
            sigma = torch.cat(
                [sigma[_nsl(sigma.ndim, axis, slice(-1, None))], sigma],
                dim=axis)
        else:
            z = torch.zeros_like(sigma[_nsl(sigma.ndim, axis, slice(0, 1))])
            sigma = torch.cat([z, sigma, z], dim=axis)
    return sigma


def node_restrict(r, pmask, dm):
    """P^T full-weighting with per-axis weights (1/2, 1, 1/2)."""
    for d in range(dm):
        axis = r.ndim - dm + d
        rm = node_shift(r, tuple(-1 if t == d else 0 for t in range(dm)),
                        pmask, dm)
        rp = node_shift(r, tuple(+1 if t == d else 0 for t in range(dm)),
                        pmask, dm)
        r = r + 0.5 * (rm + rp)
        r = r[_nsl(r.ndim, axis, slice(0, None, 2))]
    return r.contiguous()


def node_prolong(c, fine_node_shape, pmask, dm):
    """Linear interpolation: even fine nodes = coarse, odd = neighbor avg."""
    for d in range(dm):
        axis = c.ndim - dm + d
        cp = node_shift(c, tuple(+1 if t == d else 0 for t in range(dm)),
                        pmask, dm)
        mid = 0.5 * (c + cp)
        stacked = torch.stack([c, mid], dim=axis + 1)
        new_shape = list(c.shape)
        new_shape[axis] = 2 * c.shape[axis]
        out = stacked.reshape(new_shape)
        if not pmask[d]:
            out = out[_nsl(out.ndim, axis, slice(0, fine_node_shape[d]))]
        c = out
    return c


def nodal_apply_padded(phi_pad, sig_np, dxs):
    """A(sigma) phi from a ghost-padded node tensor (N+2) and the
    shifted-padded cell sigma (N+1): the factored FEM apply."""
    ext = tuple(s - 2 for s in phi_pad.shape)
    acc = None
    for d in range(3):
        tangs = [t for t in range(3) if t != d]
        g = (phi_pad.narrow(d, 1, ext[d] + 1)
             - phi_pad.narrow(d, 0, ext[d] + 1))
        corners = {}
        for q in ((0, 0), (0, 1), (1, 0), (1, 1)):
            v = g
            for qi, t in zip(q, tangs):
                v = v.narrow(t, qi, ext[t] + 1)
            corners[q] = v
        # sequential 1-D mass transform [[2,1],[1,2]] per tangential axis
        for ti in range(2):
            new = {}
            for q in corners:
                flip = tuple(1 - qq if i == ti else qq
                             for i, qq in enumerate(q))
                new[q] = 2.0 * corners[q] + corners[flip]
            corners = new
        scale = 1.0 / dxs[d]
        for t in tangs:
            scale = scale * (dxs[t] / 6.0)
        # corners span ext+1 cells on every axis, as sig_np does
        r = None
        for q, v in corners.items():
            w = (scale * sig_np) * v
            for qi, t in zip(q, tangs):
                w = w.narrow(t, 1 - qi, ext[t])
            r = w if r is None else r + w
        contrib = r.narrow(d, 0, ext[d]) - r.narrow(d, 1, ext[d])
        acc = contrib if acc is None else acc + contrib
    return acc


def nodal_sweep_3d_plain(phi_pad, sig_np, rhs, inv_diag, dxs, omega=0.85,
                         emit="jacobi", *, pmask=None, nsweeps=1, corr=None):
    """The plain PyTorch version of nodal_sweep_3d. The fused emits are the
    compositions of the single ones on padded copies: phi + prolong(corr),
    then nsweeps Jacobi sweeps (smooth); nsweeps sweeps, then the residual,
    its restriction and max|r| (smooth_restrict)."""
    if emit in ("smooth", "smooth_restrict"):
        phi, sigma = phi_pad, sig_np
        if corr is not None:
            phi = phi + node_prolong(corr, tuple(phi.shape), pmask, 3)
        sig_np = node_sigma_np(sigma, pmask, 3)
        for _ in range(nsweeps):
            phi = nodal_sweep_3d_plain(node_pad(phi, pmask, 3), sig_np, rhs,
                                       inv_diag, dxs, omega, "jacobi")
        if emit == "smooth":
            return phi
        res = nodal_sweep_3d_plain(node_pad(phi, pmask, 3), sig_np, rhs,
                                   None, dxs, omega, "residual")
        return phi, node_restrict(res, pmask, 3), res.abs().max()
    acc = nodal_apply_padded(phi_pad, sig_np, dxs)
    if emit == "apply":
        return acc
    if emit == "residual":
        return rhs - acc
    center = phi_pad[1:-1, 1:-1, 1:-1]
    return center + omega * (rhs - acc) * inv_diag


def nodal_sweep_3d(phi_pad, sig_np, rhs, inv_diag, dxs, omega=0.85,
                   emit="jacobi", *, pmask=None, nsweeps=1, corr=None):
    """One factored nodal pass, or a fused multigrid stage.

    apply / residual / jacobi: phi_pad is the (N+2) node tensor with
    ghosts, sig_np the (N+1) shifted-padded cell sigma; returns an N-node
    tensor. rhs is read by residual and jacobi, inv_diag by jacobi only.

    smooth / smooth_restrict: phi_pad is the unpadded node tensor (N) and
    sig_np the cell sigma (n cells; N = n on the axes where pmask is True,
    n + 1 elsewhere): the ghosts and the shifted sigma are formed in the
    kernel (periodic wrap, else zero). "smooth" adds the linear prolongation
    of corr (coarse nodes, n/2 cells) when given, then runs nsweeps Jacobi
    sweeps; "smooth_restrict" runs nsweeps sweeps, then returns (phi, the
    P^T full-weighting restriction of the residual, max|r|). On the card
    each is one launch for up to FUSED_SWEEPS sweeps."""
    if emit not in _NODAL_EMITS:
        raise ValueError(f"bad emit {emit!r}")
    _check_nsweeps(emit, nsweeps)
    return nodal_sweep_3d_plain(phi_pad, sig_np, rhs, inv_diag, dxs,
                                omega, emit, pmask=pmask,
                                nsweeps=nsweeps, corr=corr)


nodal_sweep_3d.launches = 0
nodal_sweep_3d.fused_launches = 0  # of them, the fused stages


# ---------------------------------------------------------------------------
# 2-D variable-beta operator
# ---------------------------------------------------------------------------

_EMITS_2D = ("sweep", "residual", "smooth", "smooth_restrict")


def gsrb_sweep_2d_plain(phi, rhs, inv_diag, beta, dx, ell_bc, bvals,
                        aco=None, alpha=0.0, *, emit="sweep", nsweeps=1,
                        corr=None, cfac=(2, 2)):
    """The plain PyTorch version of gsrb_sweep_2d."""
    return gsrb_var_sweep_3d_plain(phi, rhs, inv_diag, beta, dx, ell_bc,
                                   bvals, aco, alpha, emit=emit,
                                   nsweeps=nsweeps, corr=corr, cfac=cfac)


def gsrb_sweep_2d(phi, rhs, inv_diag, beta, dx, ell_bc, bvals, aco=None,
                  alpha=0.0, *, emit="sweep", nsweeps=1, corr=None,
                  cfac=(2, 2)):
    """One exact red-black sweep (emit="sweep"), the residual rhs - L(phi)
    (emit="residual"), or a fused multigrid stage of L = alpha*aco*phi -
    div(beta grad phi) in 2-D:

      "smooth"           phi + prolong(corr) (piecewise constant along the
                         axes whose cfac is 2; corr None adds nothing),
                         then nsweeps sweeps;
      "smooth_restrict"  nsweeps sweeps, then the residual, its 2x2 average
                         (x then y) and max|r|: returns (phi, coarse
                         residual, max|r| as a 0-d tensor); even extents
                         only.

    phi/rhs/inv_diag/aco: (n0, n1), phi without ghosts: the boundary ghosts
    come from ell_bc and bvals, afresh for each colour; beta: the (n0+1, n1)
    and (n0, n1+1) face tensors. inv_diag is read by the sweeps only, aco
    only when alpha != 0. "sweep", "residual" and "smooth" return a tensor
    of phi's shape. On the card "sweep" is two launches (one a colour),
    "residual" one, and a fused emit one launch for every FUSED_SWEEPS
    sweeps."""
    if emit not in _EMITS_2D:
        raise ValueError(f"bad emit {emit!r}")
    _check_nsweeps(emit, nsweeps)
    n = tuple(phi.shape)
    if len(n) != 2:
        raise ValueError(f"gsrb_sweep_2d: phi must be 2-D, got {n}")
    if emit == "smooth_restrict" and any(s % 2 for s in n):
        raise ValueError(f"{emit} needs even extents, got {n}")
    cfac = tuple(int(f) for f in cfac)
    if corr is not None and any(f not in (1, 2) or s % f
                                for f, s in zip(cfac, n)):
        raise ValueError(f"cfac {cfac} does not divide {n}")
    return gsrb_sweep_2d_plain(phi, rhs, inv_diag, beta, dx, ell_bc,
                               bvals, aco, alpha, emit=emit,
                               nsweeps=nsweeps, corr=corr, cfac=cfac)


gsrb_sweep_2d.launches = 0
gsrb_sweep_2d.fused_launches = 0  # of them, the fused stages


# ---------------------------------------------------------------------------
# variable-beta sweep on a ghost-padded phi
# ---------------------------------------------------------------------------

def _lphi_padded(p, beta, dxi2, aco, alpha):
    """alpha*aco*phi - div(beta grad phi) on the interior of a padded phi,
    in the order of operations of varden_tpu's _gsrb_kernel_3d."""
    bx, by, bz = beta
    c = p[1:-1, 1:-1, 1:-1]
    xm = bx[:-1] * (c - p[:-2, 1:-1, 1:-1])
    xp = bx[1:] * (p[2:, 1:-1, 1:-1] - c)
    ym = by[:, :-1] * (c - p[1:-1, :-2, 1:-1])
    yp = by[:, 1:] * (p[1:-1, 2:, 1:-1] - c)
    zm = bz[:, :, :-1] * (c - p[1:-1, 1:-1, :-2])
    zp = bz[:, :, 1:] * (p[1:-1, 1:-1, 2:] - c)
    out = -(dxi2[0] * (xp - xm) + dxi2[1] * (yp - ym)
            + dxi2[2] * (zp - zm))
    if alpha != 0.0:
        out = out + alpha * aco * c
    return out


def _pad_ring(phi, ell_bc, bvals):
    """phi with one ghost layer a side, realised as mg._pad_ghost does (x,
    then y, then z; the same formulas in the same order)."""
    for d in range(3):
        lo, hi = _ghost_planes(phi, d, ell_bc[d][0], ell_bc[d][1],
                               bvals[d][0], bvals[d][1])
        phi = torch.cat([lo, phi, hi], dim=d)
    return phi


def gsrb_sweep_3d_plain(phi, rhs, inv_diag, beta, dx, aco=None, alpha=0.0,
                        *, emit="sweep", ell_bc=None, bvals=None, nsweeps=1,
                        corr=None, cfac=(2, 2, 2)):
    """The plain PyTorch version of gsrb_sweep_3d. The fused emits are the
    composition that mg.v_cycle ran on a padded-route level before them:
    phi + prolong(corr), then nsweeps times the ghost pad and the sweep
    (smooth); then, for smooth_restrict, kernel 3's restrict emit (the
    residual with a fresh ring, its 2x2x2 average, max|r|)."""
    dxi2 = tuple(1.0 / (float(h) * float(h)) for h in dx)
    if emit != "sweep":
        if corr is not None:
            phi = phi + cell_prolong(corr, cfac)
        for _ in range(nsweeps):
            phi = gsrb_sweep_3d_plain(_pad_ring(phi, ell_bc, bvals), rhs,
                                      inv_diag, beta, dx, aco, alpha)
        if emit == "smooth":
            return phi
        return (phi, *gsrb_var_sweep_3d_plain(
            phi, rhs, inv_diag, beta, dx, ell_bc, bvals, aco, alpha,
            emit="restrict"))
    phi_pad = phi
    red = (_colour_index(rhs.shape, rhs.device) % 2 == 0).to(rhs.dtype)
    r = rhs - _lphi_padded(phi_pad, beta, dxi2, aco, alpha)
    new_int = phi_pad[1:-1, 1:-1, 1:-1] + red * r * inv_diag
    p2 = phi_pad.clone()
    p2[1:-1, 1:-1, 1:-1] = new_int
    r = rhs - _lphi_padded(p2, beta, dxi2, aco, alpha)
    return new_int + (1.0 - red) * r * inv_diag


_PADDED_EMITS = ("sweep", "smooth", "smooth_restrict")


def gsrb_sweep_3d(phi, rhs, inv_diag, beta, dx, aco=None, alpha=0.0, *,
                  emit="sweep", ell_bc=None, bvals=None, nsweeps=1,
                  corr=None, cfac=(2, 2, 2)):
    """Red-black sweeps of L = alpha*aco*phi - div(beta grad phi) whose
    ghost ring is held at the sweep's start: red cells (index sum even)
    update, then black cells from the updated red values, both colours
    reading the ring as it was before the red ones.

      "sweep"            one sweep of a phi its caller padded:
                         phi (n0+2, n1+2, n2+2) with its ghosts realised;
                         returns the updated interior (n0, n1, n2);
      "smooth"           phi (n0, n1, n2) + prolong(corr) (piecewise
                         constant along the axes whose cfac is 2; corr None
                         adds nothing), then nsweeps sweeps, each with the
                         ring that ell_bc and bvals give phi at its start
                         (mg._pad_ghost's);
      "smooth_restrict"  nsweeps such sweeps, then the residual with a
                         fresh ring, its 2x2x2 average and max|r|: returns
                         (phi, coarse residual, max|r| as a 0-d tensor);
                         even extents only.

    rhs/inv_diag/aco: (n0, n1, n2); beta: the (n0+1, n1, n2), (n0, n1+1,
    n2) and (n0, n1, n2+1) face tensors. aco is read only when alpha != 0.
    On the card "sweep" is two launches (one a colour) and a fused emit one
    launch for every FUSED_SWEEPS sweeps, or one a sweep where a periodic
    extent is odd."""
    if emit not in _PADDED_EMITS:
        raise ValueError(f"bad emit {emit!r}")
    n = tuple(rhs.shape)
    if len(n) != 3:
        raise ValueError(f"gsrb_sweep_3d: rhs must be 3-D, got {n}")
    if emit != "sweep":
        _check_nsweeps(emit, nsweeps)
        if tuple(phi.shape) != n or min(n) < 2:
            raise ValueError(f"{emit}: phi must be rhs's shape, every "
                             f"extent >= 2, got {tuple(phi.shape)}")
        if emit == "smooth_restrict" and any(s % 2 for s in n):
            raise ValueError(f"{emit} needs even extents, got {n}")
        cfac = tuple(int(f) for f in cfac)
        if corr is not None and any(f not in (1, 2) or s % f
                                    for f, s in zip(cfac, n)):
            raise ValueError(f"cfac {cfac} does not divide {n}")
    return gsrb_sweep_3d_plain(phi, rhs, inv_diag, beta, dx, aco, alpha,
                               emit=emit, ell_bc=ell_bc, bvals=bvals,
                               nsweeps=nsweeps, corr=corr, cfac=cfac)


gsrb_sweep_3d.launches = 0
gsrb_sweep_3d.fused_launches = 0  # of them, the fused stages
