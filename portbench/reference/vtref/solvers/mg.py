"""Cell-centered geometric multigrid (counterpart of varden_tpu.solvers.mg).

FBoxLib's ml_cc_solve as consumed by the reference's mac_multigrid wrapper
(src/mac_multigrid.f90:53-62): solves
    (alpha * aco - div(beta grad)) phi = rhs
with face-centered beta and periodic / Neumann / Dirichlet (face-value)
boundaries at stencil_order=2, by V-cycles with red-black Gauss-Seidel
smoothing and a dense direct bottom solve.

In 3-D the smoothing sweeps, the residuals and the restriction run through
two kernels of ops/cuda_kernels.py: gsrb_var_sweep_3d where beta is a face
tensor per axis (the MAC projection, alpha = 0: a V-cycle's level visit is
two of its fused passes, the pre-smooth with the residual and the
restriction, and the prolongation with the post-smooth; a level periodic in
x takes gsrb_sweep_3d's fused passes instead, see below),
gsrb_const_sweep_3d where
beta is one number per axis (the viscous and diffusive Helmholtz solves,
whose right-hand side may carry a leading batch axis, and the explicit
Laplacian: a V-cycle's visit of a level of at most CONST_FUSED_MAX_CELLS
cells is two of its fused passes, as for the face-tensor operator; larger
levels, the Helmholtz fast path and the bottom keep its single passes). In
2-D the face-tensor operator runs through gsrb_sweep_2d (sweeps and
residuals, and a V-cycle's level visit as two of its fused passes, as for
the 3-D face-tensor operator), and the one-number-per-axis operator runs
as plain tensor code, as it does in varden_tpu, which has no 2-D kernel
for it: masked red-black sweeps inside V-cycles, Jacobi sweeps on the
Helmholtz fast path. The loops that the JAX
package runs as lax.while_loop are Python loops here, reading the residual
norms on the host once per V-cycle.

The rule for 3-D face-tensor levels periodic in x (_padded_route: every
extent even and >= 8, no batch axis; the MAC levels of BASELINE config 4
and of the vortex tube): their sweeps hold each sweep's ghost ring at the
sweep's start, on every device, as varden_tpu's accelerator route does
(varden_tpu/solvers/mg.py:391-405: gsrb_var_sweep_3d refuses a periodic x
axis, and pallas_kernels.gsrb_sweep_3d sweeps a phi padded once a sweep).
A V-cycle visits such a level through gsrb_sweep_3d's fused passes, which
form that ring in the kernel (two sweeps a launch, the last one with the
residual and the restriction); on the CPU they are the composition they
replaced, the ghost pad and the padded sweep, then kernel 3's
restriction, bit for bit. No size rule: on an H100 a level visit through
them is faster than that composition at every size from 16^3 to 256^3 in
both dtypes (PERF.md, kernel table; tools/torch_padded_levels.py).
Kernel 3's exact sweeps extended to a periodic x axis would take these
levels to varden_tpu's CPU route instead, which agrees with the
accelerator route only to the solver's tolerance: the port's numerics
would move on config 4 and the vortex tube, and the tests that hold them
to varden_tpu's accelerator route would have to loosen.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch

from ..bc import BC_DIR, BC_NEU, BC_PER
from ..ops import cuda_kernels as ck
from ..parallel import halo

# Coarse-fine "ghost Dirichlet": the boundary value lives in the ghost CELL
BC_GHOST = 3

DEFAULT_NU1 = 2
DEFAULT_NU2 = 2
DEFAULT_MAX_CYCLES = 60
BOTTOM_SIZE = 8

# The reference's mg_bottom_solver / hg_bottom_solver integer codes
# (_parameters:55-57; FBoxLib mg_tower: 0 = smoothing sweeps, 1/3 =
# BiCGStab, 2 = CG; -1/4 the dense direct solve). The Krylov solvers
# converge to the reference's bottom_solver_eps (mac_multigrid.f90:56).
BOTTOM_METHODS = {-1: "dense", 0: "smoother", 1: "bicgstab", 2: "cg",
                  3: "bicgstab", 4: "dense"}
BOTTOM_EPS = 1.0e-3
BOTTOM_MAX_ITER = 100


def _sl(ndim, axis, s):
    out = [slice(None)] * ndim
    out[axis] = s
    return tuple(out)


def _pad_ghost(phi, ell_bc, bvals, dm, dec=None):
    """Pad with 1 ghost cell per spatial axis such that the uniform 2-point
    flux formula realizes the boundary condition:
      PER: wrap;  NEU: ghost = first interior (zero flux);
      DIR: ghost = (8/3) b - 2 phi0 + (1/3) phi1  (quadratic, face value b).
    With ``dec`` (a rank's block) the internal faces take the neighbours'
    cells instead.
    """
    for d in range(dm):
        axis = phi.ndim - dm + d
        lo_bc, hi_bc = ell_bc[d]
        lo_x, hi_x = (None, None) if dec is None else \
            halo.exchange(phi, dec, d, 1, 1)

        def take(i0, i1):
            return phi[_sl(phi.ndim, axis, slice(i0, i1))]

        if lo_x is not None:
            lo = lo_x
        elif lo_bc == BC_PER:
            lo = take(-1, None)
        elif lo_bc == BC_NEU:
            lo = take(0, 1)
        elif lo_bc == BC_GHOST:
            lo = torch.zeros_like(take(0, 1))
        else:  # BC_DIR
            lo = (8.0 / 3.0) * bvals[d][0] - 2.0 * take(0, 1) + (1.0 / 3.0) * take(1, 2)
        if hi_x is not None:
            hi = hi_x
        elif hi_bc == BC_PER:
            hi = take(0, 1)
        elif hi_bc == BC_NEU:
            hi = take(-1, None)
        elif hi_bc == BC_GHOST:
            hi = torch.zeros_like(take(-1, None))
        else:
            hi = (8.0 / 3.0) * bvals[d][1] - 2.0 * take(-1, None) + (1.0 / 3.0) * take(-2, -1)
        phi = torch.cat([lo, phi, hi], dim=axis)
    return phi


def _interior(q, dm, skip=None):
    """Crop one ghost per side on every spatial axis except ``skip``."""
    for t in range(dm):
        if t != skip:
            q = q[_sl(q.ndim, q.ndim - dm + t, slice(1, -1))]
    return q


def apply_padded(phi_pad, aco, beta, alpha, dx, dm):
    """L(phi) = alpha*aco*phi - div(beta grad phi) from a 1-ghost padded phi
    whose ghosts already realize the boundary conditions."""
    out = alpha * aco * _interior(phi_pad, dm)
    for d in range(dm):
        q = _interior(phi_pad, dm, skip=d)
        axis = q.ndim - dm + d
        grad = (q[_sl(q.ndim, axis, slice(1, None))]
                - q[_sl(q.ndim, axis, slice(0, -1))]) / dx[d]
        flux = beta[d] * grad
        out = out - (flux[_sl(flux.ndim, axis, slice(1, None))]
                     - flux[_sl(flux.ndim, axis, slice(0, -1))]) / dx[d]
    return out


@dataclasses.dataclass(frozen=True)
class CCLevel:
    """Geometry + coefficients for one MG level."""
    n: Tuple[int, ...]
    dx: Tuple[float, ...]
    ell_bc: Tuple[Tuple[int, int], ...]
    aco: torch.Tensor                     # cell coefficient (alpha multiplier)
    # beta[d]: faces along d (n_d+1), or one number per axis (constant
    # coefficient: no face tensor is ever made)
    beta: Tuple[Union[torch.Tensor, float], ...]
    alpha: float
    diag: torch.Tensor                    # operator diagonal
    inv_diag: torch.Tensor                # smoother's 1/diag (0 where diag=0)
    # per-axis coarsening factor (1 or 2) toward the next coarser level;
    # None for standalone levels / the bottom
    cfac: Optional[Tuple[int, ...]] = None
    # dense inverse of the bottom operator (bottom level only)
    binv: Optional[torch.Tensor] = None
    # a level decomposed over ranks (see make_dlevel): the rank's block
    # (parallel.mesh.Decomp), the level on the block grown by HALO cells on
    # its internal faces, and (3-D periodic-x levels) the kernel-7 level of
    # its frozen-ring sweeps
    dec: Optional[object] = None
    ext: Optional["CCLevel"] = None
    ring: Optional["CCLevel"] = None

    @property
    def dm(self):
        return len(self.n)


def _is_scalar_coef(b) -> bool:
    """beta entries may be plain numbers (constant-coefficient operators:
    the Helmholtz solves of viscsolve.f90, where beta = mu*dt)."""
    return not torch.is_tensor(b) or b.ndim == 0


def _scalar_beta(beta) -> bool:
    return all(_is_scalar_coef(b) for b in beta)


def _face_avg_down(beta_d, d, dm, fac=None):
    """Coarsen a face-centered coefficient: keep coincident planes (even
    indices along d), average 2-cell tangential blocks."""
    if _is_scalar_coef(beta_d):
        return beta_d
    if fac is None:
        fac = (2,) * dm
    out = beta_d
    if fac[d] == 2:
        out = out[_sl(out.ndim, out.ndim - dm + d, slice(0, None, 2))]
    for t in range(dm):
        if t == d or fac[t] == 1:
            continue
        ax = out.ndim - dm + t
        out = 0.5 * (out[_sl(out.ndim, ax, slice(0, None, 2))]
                     + out[_sl(out.ndim, ax, slice(1, None, 2))])
    return out


def _cell_avg_down(f, dm, fac=None):
    if fac is None:
        fac = (2,) * dm
    for d in range(dm):
        if fac[d] == 1:
            continue
        ax = f.ndim - dm + d
        f = 0.5 * (f[_sl(f.ndim, ax, slice(0, None, 2))]
                   + f[_sl(f.ndim, ax, slice(1, None, 2))])
    return f


def _make_diag(n, dx, ell_bc, aco, beta, alpha, dm):
    diag = alpha * aco
    for d in range(dm):
        axis = aco.ndim - dm + d
        dxi2 = 1.0 / dx[d] ** 2
        if _is_scalar_coef(beta[d]):
            b_lo = b_hi = torch.full_like(aco, float(beta[d]))
        else:
            nf = beta[d].shape[axis]
            b_lo = beta[d].narrow(axis, 0, nf - 1)
            b_hi = beta[d].narrow(axis, 1, nf - 1)
        # boundary-face factors: interior/periodic 1, Dirichlet 3, Neumann 0
        c_lo = torch.ones_like(b_lo)
        c_hi = torch.ones_like(b_hi)
        for side, c in ((0, c_lo), (1, c_hi)):
            code = ell_bc[d][side]
            if code in (BC_DIR, BC_NEU):
                edge = slice(0, 1) if side == 0 else slice(-1, None)
                c[_sl(c.ndim, axis, edge)] = 3.0 if code == BC_DIR else 0.0
        diag = diag + dxi2 * (c_lo * b_lo + c_hi * b_hi)
    return diag


def _inv(diag):
    return torch.where(diag != 0.0,
                       1.0 / torch.where(diag == 0.0, torch.ones_like(diag),
                                         diag),
                       torch.zeros_like(diag))


def make_level(n, dx, ell_bc, aco, beta, alpha) -> CCLevel:
    """Single CCLevel for standalone operator application."""
    dm = len(n)
    diag = _make_diag(n, dx, ell_bc, aco, beta, alpha, dm)
    return CCLevel(tuple(n), tuple(dx), tuple(map(tuple, ell_bc)), aco,
                   tuple(beta), alpha, diag, _inv(diag))


def _coarsen_plan(n, dx, dm):
    """Per-axis coarsening factors (2 = halve, 1 = keep) toward the next
    coarser level, or None to stop (semi-coarsening: halve only axes whose
    dx is near the minimum; stop at prod(n) <= BOTTOM_SIZE^dm)."""
    prod_n = 1
    for s in n:
        prod_n *= s
    if prod_n <= BOTTOM_SIZE ** dm:
        return None
    halvable = [d for d in range(dm) if n[d] % 2 == 0 and n[d] >= 4]
    if not halvable:
        return None
    dmin = min(dx[d] for d in halvable)
    return tuple(2 if (d in halvable and dx[d] <= 1.5 * dmin) else 1
                 for d in range(dm))


def laplacian(f, n, dx, ell_bc, bvals=None, dec=None):
    """lap(f) with BC-corrected boundary stencils: cc_applyop with alpha=0,
    beta=-1 (reference explicit_diffusive_term.f90:55-60). The residual of
    -lap with a zero right-hand side is lap(f): one pass of the
    constant-coefficient kernel in 3-D, the plain operator in 2-D. ``f``
    may carry a leading batch axis. With ``dec`` (a rank's block) it runs
    on the block grown by one cell from the neighbours."""
    dm = len(n)
    if bvals is None:
        bvals = [[0.0, 0.0]] * dm
    if dec is not None:
        fe = halo.extend(f, dec, 1)
        out = laplacian(fe, fe.shape[fe.ndim - dm:], dx,
                        block_codes(ell_bc, dec), bvals)
        return halo.crop(out, dec, 1)
    if dm == 2:
        aco = torch.zeros(tuple(n), dtype=f.dtype, device=f.device)
        level = make_level(n, dx, ell_bc, aco, (1.0,) * dm, 0.0)
        return -cc_apply(level, f, bvals)
    coef = [1.0 / dx[d] ** 2 for d in range(dm)] + [0.0]
    fb = f if f.ndim > dm else f[None]
    r = ck.gsrb_const_sweep_3d(fb, None, None, coef, ell_bc, bvals,
                               emit="residual")
    return r if f.ndim > dm else r[0]


def build_hierarchy(n, dx, ell_bc, aco, beta, alpha,
                    bottom: str = "dense", dec=None,
                    top: CCLevel = None) -> List[CCLevel]:
    """The level stack by factor-2 (semi-)coarsening, finest first; for the
    dense bottom solver the bottom operator's inverse is formed once
    here. With ``dec`` the finest levels are decomposed over the ranks (see
    _dbuild; ``top``: the finest one, already built)."""
    if dec is not None:
        return _dbuild(n, dx, ell_bc, aco, beta, alpha, bottom, dec, top)
    dm = len(n)
    levels = []
    while True:
        diag = _make_diag(n, dx, ell_bc, aco, beta, alpha, dm)
        fac = _coarsen_plan(n, dx, dm)
        levels.append(CCLevel(tuple(n), tuple(dx), tuple(map(tuple, ell_bc)),
                              aco, tuple(beta), alpha, diag, _inv(diag),
                              cfac=fac))
        if fac is None:
            break
        n = [n[d] // fac[d] for d in range(dm)]
        dx = [dx[d] * fac[d] for d in range(dm)]
        aco = _cell_avg_down(aco, dm, fac)
        beta = [_face_avg_down(beta[d], d, dm, fac) for d in range(dm)]
        beta = [b if _is_scalar_coef(b) else b.contiguous() for b in beta]
    lb = levels[-1]
    N = 1
    for s in lb.n:
        N *= s
    if bottom == "dense" and N <= 4096:
        A = _bottom_dense_A(lb, is_singular(ell_bc, alpha))
        eye = torch.eye(N, dtype=A.dtype, device=A.device)
        levels[-1] = dataclasses.replace(lb, binv=torch.linalg.solve(A, eye))
    return levels


def cc_apply(level: CCLevel, phi, bvals=None):
    """L(phi) = alpha*aco*phi - div(beta grad phi) on the interior (leading
    batch axes broadcast)."""
    dm = level.dm
    if bvals is None:
        bvals = [[0.0, 0.0]] * dm
    p = _pad_ghost(phi, level.ell_bc, bvals, dm)
    if _scalar_beta(level.beta):
        # constant coefficient: the direct 7-point form on the padded tensor
        def sh(d, off):
            sl = [slice(None)] * p.ndim
            for t in range(dm):
                sl[p.ndim - dm + t] = (slice(1 + off, -1 + off or None)
                                       if t == d else slice(1, -1))
            return p[tuple(sl)]

        c = sh(0, 0)
        out = (level.alpha * level.aco * c if level.alpha != 0.0
               else torch.zeros_like(c))
        for d in range(dm):
            out = out - (level.beta[d] / level.dx[d] ** 2) * (
                sh(d, 1) + sh(d, -1) - 2.0 * c)
        return out
    return apply_padded(p, level.aco, level.beta, level.alpha, level.dx, dm)


def _member_bvals(bvals):
    """Boundary values with an entry that varies over the batch axis (a
    tensor of several elements, composite_cc_solve's per-component
    values) as one [[lo, hi]] * dm of host numbers a batch member (one
    device-to-host copy of each such entry); None where every entry is
    one number."""
    if not any(torch.is_tensor(v) and v.numel() > 1 for bv in bvals
               for v in bv):
        return None
    cols = [[v.reshape(-1).tolist() if torch.is_tensor(v) else [float(v)]
             for v in bv] for bv in bvals]
    nb = max(len(c) for bv in cols for c in bv)
    return [[[c[b] if len(c) > 1 else c[0] for c in bv] for bv in cols]
            for b in range(nb)]


def _const_sweep(level: CCLevel, phi, rhs, bvals, emit, corr=None,
                 **fused):
    """One gsrb_const_sweep_3d pass on a scalar-beta level; phi, rhs and
    corr may carry the batch axis or not (``fused``: nsweeps and cfac of
    kernel 5's fused emits)."""
    per = _member_bvals(bvals)
    if per is not None and any(bv != per[0] for bv in per):
        # per-component boundary values (the batched viscous solve of an
        # AMR run whose hierarchy is one level): the kernel takes one set
        # a call, so each batch member goes through it with its own
        outs = [_const_sweep(level, phi[b:b + 1],
                             None if rhs is None else rhs[b:b + 1], bv, emit,
                             None if corr is None else corr[b:b + 1], **fused)
                for b, bv in enumerate(per)]
        if emit == "smooth_restrict":
            return (torch.cat([o[0] for o in outs]),
                    torch.cat([o[1] for o in outs]),
                    torch.stack([o[2] for o in outs]).max())
        return torch.cat(outs)
    if per is not None:
        bvals = per[0]
    coef = [level.beta[d] / level.dx[d] ** 2 for d in range(level.dm)]
    coef.append(level.alpha)
    batched = phi.ndim > level.dm
    if corr is not None and not batched:
        corr = corr[None]
    out = ck.gsrb_const_sweep_3d(
        phi if batched else phi[None], rhs if batched else rhs[None],
        level.inv_diag, coef, level.ell_bc, bvals,
        aco=level.aco if level.alpha != 0.0 else None, emit=emit, corr=corr,
        **fused)
    if batched:
        return out
    return (out[0][0], out[1][0], out[2]) if emit == "smooth_restrict" \
        else out[0]


def _var_sweep(level: CCLevel, phi, rhs, bvals, emit, **fused):
    """One pass of the face-tensor-beta kernel of the level's dimension
    (``fused``: nsweeps, corr and cfac of kernel 3's fused emits)."""
    kernel = ck.gsrb_var_sweep_3d if level.dm == 3 else ck.gsrb_sweep_2d
    return kernel(phi, rhs, level.inv_diag, level.beta, level.dx,
                  level.ell_bc, bvals, aco=level.aco, alpha=level.alpha,
                  emit=emit, **fused)


def _fused_route(level: CCLevel, phi) -> bool:
    """Whether the level smooths through the fused stages of its
    face-tensor kernel (3 in 3-D, 8 in 2-D): a face-tensor level without a
    batch axis that is not on _padded_route."""
    return (phi.ndim == level.dm
            and not any(_is_scalar_coef(b) for b in level.beta)
            and not _padded_route(level, phi))


# The largest level, in cells, whose V-cycle visits run through kernel 5's
# fused stages. Measured on an H100 (PERF.md, kernel table): up to 64^3
# cells a level visit through the fused stages is 2.3-5.3x faster than the
# single passes, which are launch-bound there, in both dtypes and batches;
# above, it is faster in some cases and slower in others, and from 240^3
# on slower (the single passes take 0.56-0.96 of its time), so the
# single passes stay.
# mg.gsrb (the Helmholtz fast path, which smooths a solve's finest level,
# 128^3 and more on the 3-D paths) keeps the single passes: a fused sweep
# there is slower. The rule reads the level's extents only, never the
# device or the dtype, so on the CPU both routes compute the same plain
# composition.
CONST_FUSED_MAX_CELLS = 64 ** 3


def _const_fused_route(level: CCLevel) -> bool:
    """Whether a V-cycle's visit of the level runs through kernel 5's fused
    stages: a 3-D scalar-beta level of at most CONST_FUSED_MAX_CELLS cells,
    with or without a batch axis."""
    return (level.dm == 3 and _scalar_beta(level.beta)
            and math.prod(level.n) <= CONST_FUSED_MAX_CELLS)


def _residual(level: CCLevel, phi, rhs, bvals):
    """rhs - L(phi): through the level's kernel, or (2-D, scalar beta) the
    plain operator."""
    if level.dec is not None:
        return _dresidual(level, phi, rhs, bvals)
    if not _scalar_beta(level.beta):
        return _var_sweep(level, phi, rhs, bvals, "residual")
    if level.dm == 3:
        return _const_sweep(level, phi, rhs, bvals, "residual")
    return rhs - cc_apply(level, phi, bvals)


def _padded_route(level: CCLevel, phi) -> bool:
    """Whether the level's sweeps take gsrb_sweep_3d on a ghost-padded phi:
    where varden_tpu's accelerator route does (varden_tpu/solvers/mg.py
    :371-404: gsrb_var_sweep_3d refuses a periodic x axis, and the padded
    kernel takes 3-D face-tensor levels of even extents >= 8). The rule
    looks at the level only (the whole level where it is decomposed), never
    at the device or the dtype."""
    n, per_x = level.n, BC_PER in level.ell_bc[0]
    if level.dec is not None:
        n, per_x = level.dec.n_glob, level.dec.pmask[0]
    return (level.dm == 3 and phi.ndim == 3
            and not any(_is_scalar_coef(b) for b in level.beta)
            and per_x and all(s >= 8 and s % 2 == 0 for s in n))


def _padded_sweep(level: CCLevel, phi, rhs, bvals, emit, **fused):
    """A fused pass of gsrb_sweep_3d on a _padded_route level (``fused``:
    nsweeps, corr and cfac): the sweeps' ghost rings formed in the kernel."""
    return ck.gsrb_sweep_3d(phi, rhs, level.inv_diag, level.beta, level.dx,
                            aco=level.aco, alpha=level.alpha, emit=emit,
                            ell_bc=level.ell_bc, bvals=bvals, **fused)


def gsrb(level: CCLevel, phi, rhs, bvals, nsweeps):
    """nsweeps red-black Gauss-Seidel sweeps (red: index sum even): exact,
    or, on a level of _padded_route, each with the ghost ring of its start,
    so the black cells see the ghosts of the sweep's start."""
    if level.dec is not None:
        return _dgsrb(level, phi, rhs, bvals, nsweeps)
    if _padded_route(level, phi):
        return _padded_sweep(level, phi, rhs, bvals, "smooth",
                             nsweeps=nsweeps)
    if _fused_route(level, phi):
        return _var_sweep(level, phi, rhs, bvals, "smooth", nsweeps=nsweeps)
    if not _scalar_beta(level.beta):
        for _ in range(nsweeps):
            phi = _var_sweep(level, phi, rhs, bvals, "sweep")
        return phi
    if level.dm == 3:
        for _ in range(nsweeps):
            phi = _const_sweep(level, phi, rhs, bvals, "sweep")
        return phi
    # 2-D scalar beta: the masked sweep on the plain operator
    colour = ck._colour_index(level.n, phi.device) % 2
    for _ in range(nsweeps):
        for c in (0, 1):
            r = rhs - cc_apply(level, phi, bvals)
            phi = torch.where(colour == c, phi + r * level.inv_diag, phi)
    return phi


def jacobi(level: CCLevel, phi, rhs, bvals, nsweeps):
    """Plain (undamped) Jacobi sweeps on the plain operator: the smoother
    of the 2-D Helmholtz fast path, where the Jacobi iteration matrix norm
    gamma = |offdiag|/diag is already well below 1."""
    for _ in range(nsweeps):
        r = (_dresidual(level, phi, rhs, bvals) if level.dec is not None
             else rhs - cc_apply(level, phi, bvals))
        phi = phi + r * level.inv_diag
    return phi


def _mean_sp(x, dm, dec=None):
    """Mean over the spatial (last dm) axes, keepdims: per batch element
    when a leading batch axis is present; over the whole level where ``x``
    is a rank's block (``dec``)."""
    axes = tuple(range(x.ndim - dm, x.ndim))
    if dec is None:
        return x.mean(dim=axes, keepdim=True)
    return halo.all_sum(x.sum(dim=axes, keepdim=True)) / math.prod(dec.n_glob)


def _gmax(x, dec=None):
    """max|x| (a 0-d tensor), over every rank's block with ``dec``."""
    m = x.abs().max()
    return m if dec is None else halo.all_max(m)


def _bottom_dense_A(level: CCLevel, singular: bool):
    """The (tiny) coarsest operator, by applying it to the identity;
    rank-1 regularized along the constant null space when singular."""
    N = 1
    for s in level.n:
        N *= s
    eye = torch.eye(N, dtype=level.diag.dtype, device=level.diag.device)
    cols = cc_apply(level, eye.reshape((N,) + tuple(level.n)),
                    [[0.0, 0.0]] * level.dm).reshape(N, N)
    A = cols.T
    if singular:
        A = A + 1.0 / N
    return A


def bottom_dense_solve(level: CCLevel, r, singular: bool):
    """Direct bottom solve: one product with the precomputed inverse, or a
    dense solve when the bottom was too large to invert once. A leading
    batch axis on r gives several right-hand sides to the one operator."""
    N = math.prod(level.n)
    rr = r.reshape(-1, N)
    if level.binv is not None:
        return (rr @ level.binv.T).reshape(r.shape)
    A = _bottom_dense_A(level, singular)
    return torch.linalg.solve(A, rr.T).T.reshape(r.shape)


def _krylov_bottom(apply_fn, r, spatial_axes, method, eps=BOTTOM_EPS,
                   max_iter=BOTTOM_MAX_ITER):
    """Matrix-free CG / BiCGStab on the bottom level, batched over any
    leading axes of ``r`` (per-batch step lengths, joint max-norm stop).
    Every iteration's stop test is a host read; bottoms are <= 8^3."""
    def dot(a, b):
        return (a * b).sum(dim=spatial_axes, keepdim=True)

    tiny = torch.finfo(r.dtype).tiny
    tol = eps * float(r.abs().max())
    x = torch.zeros_like(r)
    rr = r

    if method == "cg":
        p, rs = r, dot(r, r)
        for _ in range(max_iter):
            if not float(rr.abs().max()) > tol:
                break
            ap = apply_fn(p)
            alpha = rs / dot(p, ap).clamp(min=tiny)
            x = x + alpha * p
            rr = rr - alpha * ap
            rs2 = dot(rr, rr)
            p = rr + (rs2 / rs.clamp(min=tiny)) * p
            rs = rs2
        return x

    # BiCGStab (FBoxLib's default bottom solver). Batch elements that have
    # already converged are frozen: the recurrences break down (0/0 in
    # rho/omega) once a residual hits exact zero while other elements of
    # the joint loop still iterate.
    def safe(d):
        # sign-preserving zero guard: BiCGStab denominators (rho, omega,
        # <r0h,v>) are legitimately negative; clamping with max() would
        # flip them to +tiny and blow the recurrence up
        t = torch.full_like(d, tiny)
        return torch.where(d.abs() > tiny, d, torch.where(d >= 0.0, t, -t))

    r0h = r
    p = v = torch.zeros_like(r)
    rho = alpha = omega = torch.ones_like(dot(r, r))
    for _ in range(max_iter):
        if not float(rr.abs().max()) > tol:
            break
        live = rr.abs().amax(dim=spatial_axes, keepdim=True) > tol
        rho2 = dot(r0h, rr)
        beta = (rho2 / safe(rho)) * (alpha / safe(omega))
        p2 = rr + beta * (p - omega * v)
        v2 = apply_fn(p2)
        alpha2 = rho2 / safe(dot(r0h, v2))
        s = rr - alpha2 * v2
        t = apply_fn(s)
        omega2 = dot(t, s) / safe(dot(t, t))
        x2 = x + alpha2 * p2 + omega2 * s
        rr2 = s - omega2 * t
        x, rr, p, v = (torch.where(live, new, old) for new, old in
                       ((x2, x), (rr2, rr), (p2, p), (v2, v)))
        rho, alpha, omega = (torch.where(live, new, old) for new, old in
                             ((rho2, rho), (alpha2, alpha), (omega2, omega)))
    return x


def bottom_solve(level: CCLevel, r, singular: bool, method: str = "dense"):
    """Bottom-solver dispatch (see BOTTOM_METHODS)."""
    if method == "dense":
        return bottom_dense_solve(level, r, singular)
    zero_bv = [[0.0, 0.0]] * level.dm
    if method == "smoother":
        # FBoxLib bottom_solver=0: a fixed budget of smoothing sweeps
        return gsrb(level, torch.zeros_like(r), r, zero_bv, 10)

    def apply_fn(x):
        y = cc_apply(level, x, zero_bv)
        if singular:
            # the dense path's rank-1 regularization: A + J/N keeps the
            # operator SPD on the mean-free complement
            y = y + _mean_sp(x, level.dm)
        return y

    if singular:
        r = r - _mean_sp(r, level.dm)
    spatial = tuple(range(r.ndim - level.dm, r.ndim))
    return _krylov_bottom(apply_fn, r, spatial, method)


def v_cycle(levels: List[CCLevel], phi, rhs, bvals, lev=0,
            nu1=DEFAULT_NU1, nu2=DEFAULT_NU2, singular=False,
            return_resnorm=False, bottom="dense"):
    """One V-cycle. With return_resnorm, also returns the max-norm of the
    post-pre-smooth fine residual (a 0-d tensor), which the restriction
    computes anyway."""
    level = levels[lev]
    bv = bvals if lev == 0 else [[0.0, 0.0]] * level.dm
    if level.dec is not None:
        return _dv_cycle(levels, phi, rhs, bvals, lev, nu1, nu2, singular,
                         return_resnorm, bottom)
    if lev == len(levels) - 1:
        r = _residual(level, phi, rhs, bv)
        if singular:
            r = r - _mean_sp(r, level.dm)
        out = phi + bottom_solve(level, r, singular, bottom)
        return (out, r.abs().max()) if return_resnorm else out
    fac = level.cfac if level.cfac is not None else (2,) * level.dm
    fused = _fused_route(level, phi)
    padded = _padded_route(level, phi)
    cfused = _const_fused_route(level)
    full = fac == (2,) * level.dm and all(s % 2 == 0 for s in level.n)
    if fused and full:
        # nu1 sweeps, the residual, its 2^dm restriction and max|r|: one
        # pass of kernel 3 or 8
        phi, crs, rmax = _var_sweep(level, phi, rhs, bv, "smooth_restrict",
                                    nsweeps=nu1)
    elif padded and full:
        # the same with the frozen rings: nu1 passes of kernel 7
        phi, crs, rmax = _padded_sweep(level, phi, rhs, bv,
                                       "smooth_restrict", nsweeps=nu1)
    elif cfused and full:
        # the same through kernel 5, max|r| over the batch
        phi, crs, rmax = _const_sweep(level, phi, rhs, bv,
                                      "smooth_restrict", nsweeps=nu1)
    else:
        phi = gsrb(level, phi, rhs, bv, nu1)
        if level.dm == 3 and not _scalar_beta(level.beta) and full:
            # residual + 2^dm restriction + max|r| in one pass
            crs, rmax = _var_sweep(level, phi, rhs, bv, "restrict")
        else:
            res = _residual(level, phi, rhs, bv)
            crs = _cell_avg_down(res, level.dm, fac)
            rmax = res.abs().max()
    corr = v_cycle(levels, torch.zeros_like(crs), crs, bvals, lev + 1, nu1,
                   nu2, singular, bottom=bottom)
    if fused or cfused or padded:
        # phi + the piecewise-constant prolongation of corr, then nu2 sweeps:
        # one pass of kernel 3, 5 or 8, or nu2 of kernel 7
        sweep = (_var_sweep if fused else
                 _padded_sweep if padded else _const_sweep)
        phi = sweep(level, phi, rhs, bv, "smooth", nsweeps=nu2, corr=corr,
                    cfac=fac)
        return (phi, rmax) if return_resnorm else phi
    # piecewise-constant prolongation (only the coarsened axes)
    phi = gsrb(level, phi + ck.cell_prolong(corr, fac), rhs, bv, nu2)
    return (phi, rmax) if return_resnorm else phi


# ---------------------------------------------------------------------------
# Levels decomposed over ranks
# ---------------------------------------------------------------------------
# A decomposed level holds the rank's block of every tensor. Its passes run
# on the block grown by HALO cells from the neighbours on each internal face
# (parallel.halo.extend), with the level's own boundary codes on the
# physical faces and BC_PER on the internal ones, and keep the block: the
# grown cells see a wrong boundary, but a residual spoils only the outermost
# of them and one red-black sweep the outer two, so the block's cells come
# out as the whole level's would, bit for bit. A sweep is one exchange and
# one single-sweep pass of the level's kernel (3, 5 or 8; the 2-D
# one-number operator in plain code); on the periodic-x levels of
# _padded_route one pass of kernel 7 on a ring formed at the sweep's start,
# the wrapped neighbour's cells across a periodic seam, so that the rule of
# this module's docstring holds across the seam while the internal faces
# stay exact. The fused stages, whose ghost ring the kernels form from the
# level's boundary codes, run on the levels gathered onto every rank below
# the decomposed ones (_dbuild).

HALO = 2


def block_codes(ell_bc, dec):
    """The boundary codes of a rank's block: BC_PER on its internal faces
    (the grown cells' outer ring, which no kept cell reads)."""
    return tuple(tuple(BC_PER if dec.internal(d, s) else ell_bc[d][s]
                       for s in range(2)) for d in range(len(ell_bc)))


def _grow_beta(beta, dec, k):
    return tuple(b if _is_scalar_coef(b) else
                 halo.extend(b, dec, k, [t == d for t in range(dec.dm)])
                 for d, b in enumerate(beta))


def _seam_cut(dec, d, side):
    return HALO if dec.seam(d, side) else 0


def _cut(f, dec, cuts):
    """Narrow the trailing dm axes by cuts[d] = (lo, hi)."""
    for d, (lo, hi) in enumerate(cuts):
        ax = f.ndim - dec.dm + d
        f = f.narrow(ax, lo, f.shape[ax] - lo - hi)
    return f


def make_dlevel(n, dx, ell_bc, aco, beta, alpha, dec, cfac=None) -> CCLevel:
    """A level decomposed over ranks: the rank's block (``n`` its cells,
    ``aco`` and ``beta`` its coefficients, ``ell_bc`` the whole level's
    codes) with the grown level of its passes."""
    dm = len(n)
    codes = block_codes(ell_bc, dec)
    level = dataclasses.replace(make_level(n, dx, codes, aco, beta, alpha),
                                cfac=cfac, dec=dec)
    aco_e = halo.extend(aco, dec, HALO)
    beta_e = _grow_beta(beta, dec, HALO)
    ext = make_level(aco_e.shape[aco_e.ndim - dm:], dx, codes, aco_e,
                     beta_e, alpha)
    ring = None
    if _padded_route(level, aco):
        # kernel 7's interior: the grown block less the periodic seams,
        # where the ring is the wrapped neighbour's cells
        cuts = [(_seam_cut(dec, d, 0), _seam_cut(dec, d, 1))
                for d in range(dm)]
        inv = _cut(ext.inv_diag, dec, cuts).contiguous()
        ring = dataclasses.replace(
            ext, n=tuple(inv.shape), aco=_cut(aco_e, dec, cuts).contiguous(),
            beta=tuple(_cut(b, dec, cuts).contiguous() for b in beta_e),
            inv_diag=inv, diag=_cut(ext.diag, dec, cuts))
    return dataclasses.replace(level, ext=ext, ring=ring)


def _dresidual(level: CCLevel, phi, rhs, bvals):
    dec, e = level.dec, level.ext
    phi_e = halo.extend(phi, dec, HALO)
    rhs_e = _zero_grow(rhs, dec)
    return halo.crop(_residual(e, phi_e, rhs_e, bvals), dec, HALO)


def _zero_grow(f, dec):
    """``f`` grown by HALO zeros on the internal faces (a residual's
    right-hand side there is never kept)."""
    for d in range(dec.dm):
        ax = f.ndim - dec.dm + d
        parts = [f]
        for side in (0, 1):
            if dec.internal(d, side):
                shape = list(f.shape)
                shape[ax] = HALO
                z = f.new_zeros(shape)
                parts.insert(0 if side == 0 else len(parts), z)
        f = torch.cat(parts, dim=ax)
    return f


def _sweep_grown(e: CCLevel, phi_e, rhs_e, bvals):
    """One exact red-black sweep on a grown level: the single-sweep emit
    of its kernel, or (2-D, scalar beta) the masked sweep."""
    if not _scalar_beta(e.beta):
        return _var_sweep(e, phi_e, rhs_e, bvals, "sweep")
    if e.dm == 3:
        return _const_sweep(e, phi_e, rhs_e, bvals, "sweep")
    colour = ck._colour_index(e.n, phi_e.device) % 2
    for c in (0, 1):
        r = rhs_e - cc_apply(e, phi_e, bvals)
        phi_e = torch.where(colour == c, phi_e + r * e.inv_diag, phi_e)
    return phi_e


def _ring_sweep(level: CCLevel, phi_e, rhs_e, bvals):
    """One kernel-7 sweep of a decomposed _padded_route level: the ring is
    phi at the sweep's start, the wrapped neighbour's across a periodic
    seam and the level's boundary rule on the other faces that bound the
    whole level."""
    dec, g = level.dec, level.ring
    dm = level.dm
    cuts = [(_seam_cut(dec, d, 0), _seam_cut(dec, d, 1)) for d in range(dm)]
    inner = _cut(phi_e, dec, cuts)
    codes = tuple(tuple(BC_NEU if dec.seam(d, s) else g.ell_bc[d][s]
                        for s in range(2)) for d in range(dm))
    p = _pad_ghost(inner, codes, bvals, dm)
    for d in range(dm):
        for side in (0, 1):
            if not dec.seam(d, side):
                continue
            ax = phi_e.ndim - dm + d
            src = phi_e.narrow(ax, HALO - 1 if side == 0
                               else phi_e.shape[ax] - HALO, 1)
            src = _cut(src, dec, [(0, 0) if t == d else cuts[t]
                                  for t in range(dm)])
            sl = [slice(None)] * p.ndim
            for t in range(dm):
                sl[p.ndim - dm + t] = ((slice(0, 1) if side == 0
                                        else slice(-1, None)) if t == d
                                       else slice(1, -1))
            p[tuple(sl)] = src
    out = ck.gsrb_sweep_3d(p, _cut(rhs_e, dec, cuts).contiguous(),
                           g.inv_diag, g.beta,
                           g.dx, aco=g.aco, alpha=g.alpha, emit="sweep")
    keep = [(HALO - cuts[d][0] if dec.internal(d, 0) else 0,
             HALO - cuts[d][1] if dec.internal(d, 1) else 0)
            for d in range(dm)]
    return _cut(out, dec, keep)


def _dgsrb(level: CCLevel, phi, rhs, bvals, nsweeps):
    """nsweeps sweeps of a decomposed level: an exchange of HALO cells and
    one single-sweep pass each."""
    dec = level.dec
    rhs_e = halo.extend(rhs, dec, HALO)
    for _ in range(nsweeps):
        phi_e = halo.extend(phi, dec, HALO)
        if level.ring is not None:
            phi = _ring_sweep(level, phi_e, rhs_e, bvals)
        else:
            phi = halo.crop(_sweep_grown(level.ext, phi_e, rhs_e, bvals),
                            dec, HALO)
    return phi


def _dbuild(n, dx, ell_bc, aco, beta, alpha, bottom, dec, top):
    """The hierarchy of a decomposed solve: each rank coarsens its block
    while the coarser level keeps blocks (Decomp.keeps_blocks) and is not
    the bottom; from the first level that does not, every rank holds the
    whole level (gathered, exact) and the rest of the hierarchy, down to
    the dense bottom, as a one-rank solve would."""
    dm = len(n)
    levels = []
    while True:
        fac = _coarsen_plan(dec.n_glob, dx, dm)
        if fac is None or dec.coarsen(fac) is None:
            raise NotImplementedError(
                f"a decomposed level of {dec.n_glob} cells must coarsen "
                f"into the rank blocks {dec.n}")
        if top is not None and not levels:
            levels.append(dataclasses.replace(top, cfac=fac))
        else:
            levels.append(make_dlevel(n, dx, ell_bc, aco, beta, alpha, dec,
                                      cfac=fac))
        cdec = dec.coarsen(fac)
        n = cdec.n
        dx = [dx[d] * fac[d] for d in range(dm)]
        aco = _cell_avg_down(aco, dm, fac)
        beta = [_face_avg_down(beta[d], d, dm, fac) for d in range(dm)]
        beta = [b if _is_scalar_coef(b) else b.contiguous() for b in beta]
        if cdec.keeps_blocks() and _coarsen_plan(cdec.n_glob, dx, dm):
            dec = cdec
            continue
        aco = halo.gather(aco, cdec)
        beta = [b if _is_scalar_coef(b) else
                halo.gather(b, cdec, [int(t == d) for t in range(dm)])
                for d, b in enumerate(beta)]
        return levels + build_hierarchy(list(cdec.n_glob), dx, ell_bc, aco,
                                        beta, alpha, bottom=bottom)


def _dv_cycle(levels, phi, rhs, bvals, lev, nu1, nu2, singular,
              return_resnorm, bottom):
    """v_cycle's visit of a decomposed level: nu1 sweeps, the residual and
    its restriction on the block; the coarser level's correction, through
    the whole level on every rank where that is gathered; its prolongation
    and nu2 sweeps."""
    level = levels[lev]
    dec, dm = level.dec, level.dm
    bv = bvals if lev == 0 else [[0.0, 0.0]] * dm
    fac = level.cfac
    phi = _dgsrb(level, phi, rhs, bv, nu1)
    res = _dresidual(level, phi, rhs, bv)
    crs = _cell_avg_down(res, dm, fac)
    rmax = _gmax(res, dec)
    cdec = None if levels[lev + 1].dec is not None else dec.coarsen(fac)
    if cdec is not None:
        crs = halo.gather(crs, cdec)
    corr = v_cycle(levels, torch.zeros_like(crs), crs, bvals, lev + 1, nu1,
                   nu2, singular, bottom=bottom)
    if cdec is not None:
        corr = cdec.block(corr)
    phi = _dgsrb(level, phi + ck.cell_prolong(corr, fac), rhs, bv, nu2)
    return (phi, rmax) if return_resnorm else phi


def roundoff_floor(diag_max, phi_max, dtype):
    """The residual norm a solve in ``dtype`` can attain, 4 eps * max|diag| *
    max|phi|: every solver's stopping tolerance is at least this."""
    return 4.0 * torch.finfo(dtype).eps * diag_max * phi_max


def is_singular(ell_bc, alpha) -> bool:
    return alpha == 0.0 and all(bc in (BC_PER, BC_NEU)
                                for pair in ell_bc for bc in pair)


def solve(n, dx, ell_bc, aco, beta, rhs, *, alpha=0.0, bvals=None, phi0=None,
          rel_eps=1.0e-12, abs_eps=-1.0, max_cycles=DEFAULT_MAX_CYCLES,
          nu1=DEFAULT_NU1, nu2=DEFAULT_NU2, return_info=False,
          bottom="dense", dec=None):
    """Solve (alpha*aco - div beta grad) phi = rhs. Returns (phi, resnorm),
    or (phi, (resnorm, cycles, ratio)) with return_info; resnorm and ratio
    are 0-d tensors.

    With scalar beta, rhs/phi0 may carry a leading batch axis (one operator,
    several right-hand sides: the per-component Helmholtz solves of
    viscsolve.f90:94-105): every stage runs on the whole batch with a joint
    (max over the batch) tolerance.

    The Helmholtz fast path of varden_tpu.solvers.mg.solve (:768-824): when
    alpha != 0 and the operator is strongly diagonally dominant (gamma =
    max offdiag/diag < 0.5, the viscous solves at a CFL-limited dt), a
    budget of at most 40 fine-level sweeps, sized from the measured starting
    residual and the contraction bound per sweep, replaces V-cycles:
    red-black sweeps (gamma^2 per sweep) through the level's kernel, or, in
    2-D with scalar beta, Jacobi sweeps (gamma per sweep) as varden_tpu runs
    there on every backend. The V-cycle loop below stays as the safety net
    and builds its hierarchy only if the smoothed residual still misses the
    tolerance.

    The tolerance loop (:826-891): an inner loop runs V-cycles while the
    in-cycle residual monitor keeps falling below 0.7x its previous value;
    an outer loop re-checks the true residual and stops after two passes
    without a 0.9x contraction (the dtype's roundoff floor). The effective
    tolerance includes that floor, 4 eps * max|diag| * max|phi|.

    With ``dec`` (parallel.mesh.Decomp) the solve is decomposed over the
    ranks: n, aco, beta, rhs and phi0 are the rank's block, ell_bc the whole
    level's codes. The max norms are all-reduced (exact), the singular
    means summed over the ranks (the one place where the result depends on
    the decomposition, by roundoff), and the hierarchy is _dbuild's."""
    dm = len(n)
    if bvals is None:
        bvals = [[0.0, 0.0]] * dm
    singular = is_singular(ell_bc, alpha)
    if dec is None:
        L0 = make_level(list(n), list(dx), ell_bc, aco, tuple(beta), alpha)
    else:
        L0 = make_dlevel(list(n), list(dx), ell_bc, aco, tuple(beta), alpha,
                         dec)
    if singular:
        rhs = rhs - _mean_sp(rhs, dm, dec)
    phi = torch.zeros_like(rhs) if phi0 is None else phi0
    dtype = rhs.dtype
    bnorm = _gmax(rhs, dec)
    tol = torch.clamp(rel_eps * bnorm, min=0.0 if abs_eps < 0 else abs_eps)
    diag_max = _gmax(L0.diag, dec)

    def tol_eff(p):
        floor = roundoff_floor(diag_max, _gmax(p, dec), dtype)
        return float(torch.maximum(tol, floor))

    def resnorm(p):
        return _gmax(_residual(L0, p, rhs, bvals), dec)

    rn = resnorm(phi)
    if alpha != 0.0:
        # Jacobi contraction bound gamma = max offdiag/diag: a red-black
        # sweep of the consistently ordered 7-point operator contracts the
        # error by about gamma^2. The budget is sized from the measured
        # starting residual (the warm starts these solves get are decades
        # inside a cold start) and respects the dtype's attainable floor.
        safe_diag = torch.where(L0.diag == 0.0, torch.ones_like(L0.diag),
                                L0.diag)
        gmax = ((L0.diag - alpha * L0.aco) / safe_diag).max()
        if dec is not None:
            gmax = halo.all_max(gmax)
        gamma, rin, bn = torch.stack([gmax, rn, bnorm]).tolist()
        gamma = min(max(gamma, 1.0e-6), 1.0)
        target = max(tol_eff(phi), 1.0e-14 * bn)
        k_smooth = 0
        use_jacobi = dm == 2 and _scalar_beta(beta)
        per_sweep = 1.0 if use_jacobi else 2.0
        # a non-finite rin (diverged prior state, bad warm start) falls
        # through to the V-cycle branch with no sweeps
        if gamma < 0.5 and math.isfinite(rin) and rin > target:
            ratio = target / max(rin, torch.finfo(dtype).tiny)
            k_need = math.ceil(math.log(ratio)
                               / (per_sweep * math.log(gamma))) + 2
            k_smooth = min(max(k_need, 0), 40)
        if k_smooth > 0:
            smooth = jacobi if use_jacobi else gsrb
            phi = smooth(L0, phi, rhs, bvals, k_smooth)
            rn = resnorm(phi)
    iters = 0
    if float(rn) > tol_eff(phi):
        levels = build_hierarchy(list(n), list(dx), ell_bc, aco, list(beta),
                                 alpha, bottom=bottom, dec=dec, top=L0)
        kw = dict(singular=singular, return_resnorm=True, bottom=bottom)
        stall = 0
        while iters < max_cycles and float(rn) > tol_eff(phi) and stall < 2:
            tl = tol_eff(phi)
            phi, mon = v_cycle(levels, phi, rhs, bvals, 0, nu1, nu2, **kw)
            iters += 1
            mon, prev = float(mon), float("inf")
            while iters < max_cycles and mon > tl and mon < 0.7 * prev:
                phi, mon2 = v_cycle(levels, phi, rhs, bvals, 0, nu1, nu2,
                                    **kw)
                iters += 1
                mon, prev = float(mon2), mon
            rn_new = resnorm(phi)
            stall = stall + 1 if float(rn_new) > 0.9 * float(rn) else 0
            rn = rn_new
    if singular:
        phi = phi - _mean_sp(phi, dm, dec)
    if return_info:
        tiny = torch.finfo(dtype).tiny
        ratio = rn / max(tol_eff(phi), tiny)
        return phi, (rn, iters, ratio)
    return phi, rn
