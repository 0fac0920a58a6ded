"""Cell-update, forcing and dt-estimation ops (counterpart of
varden_tpu.ops.basic; reference update (src/update.f90:113-278), mkforce
(src/mkforce.f90:18-404), estdt (src/estdt.f90:15-183), make_at_halftime
(src/make_at_halftime.f90:18-119)). All functions take interior-only
tensors; spatial axes are the trailing ones.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _fdiff(face_arr, d, dm):
    """hi-face minus lo-face per cell along axis d for a face tensor whose
    axis d has n_d+1 entries."""
    axis = face_arr.ndim - dm + d
    n = face_arr.shape[axis]
    return face_arr.narrow(axis, 1, n - 1) - face_arr.narrow(axis, 0, n - 1)


def _fmean(face_arr, d, dm):
    axis = face_arr.ndim - dm + d
    n = face_arr.shape[axis]
    return 0.5 * (face_arr.narrow(axis, 1, n - 1)
                  + face_arr.narrow(axis, 0, n - 1))


def mac_div(umac: Sequence[torch.Tensor], dx: Sequence[float]) -> torch.Tensor:
    """div(umac) on cells from interior MAC faces (macproject divumac,
    src/macproject.f90:228-254)."""
    dm = len(umac)
    return sum(_fdiff(umac[d], d, dm) / dx[d] for d in range(dm))


def update(sold: torch.Tensor, umac: Sequence[torch.Tensor],
           sedge: Sequence[torch.Tensor], flux: Sequence[torch.Tensor],
           force, dt, dx: Sequence[float],
           is_conservative: Sequence[bool]) -> torch.Tensor:
    """snew = sold - dt*(u·grad s | div flux) + dt*force (reference
    update_2d/3d, src/update.f90:113-278). sold/force: (nc, *n);
    sedge[d]/flux[d]: (nc, faces); umac[d]: (faces). ``force`` may be None
    (statically zero). In 3-D it runs through the update_3d kernel (which
    builds on update_plain below), as varden_tpu does on the TPU."""
    if len(umac) == 3:
        from .cuda_update import update_3d
        return update_3d(sold, umac, sedge, flux, force, dt, dx,
                         is_conservative)
    return update_plain(sold, umac, sedge, flux, force, dt, dx,
                        is_conservative)


def update_plain(sold, umac, sedge, flux, force, dt, dx, is_conservative):
    """The update on plain tensors, in any dimension; ``sedge`` or ``flux``
    may be None where no component reads it."""
    dm = len(umac)
    ubar = [_fmean(umac[d], d, dm) for d in range(dm)]
    out = []
    for c in range(sold.shape[0]):
        if is_conservative[c]:
            adv = sum(_fdiff(flux[d][c], d, dm) / dx[d] for d in range(dm))
        else:
            adv = sum(ubar[d] * _fdiff(sedge[d][c], d, dm) / dx[d]
                      for d in range(dm))
        val = sold[c] - dt * adv
        if force is not None:
            val = val + dt * force[c]
        out.append(val)
    return torch.stack(out)


def mkvelforce(ext_force: Sequence[float], s: torch.Tensor, gp: torch.Tensor,
               lapu, visc_coef: float, visc_fac: float,
               boussinesq: int) -> torch.Tensor:
    """Cell velocity forcing: ext(*tracer if boussinesq) + (visc*lapu - gp)/rho
    (reference mkvelforce_2d/3d, src/mkforce.f90:82-236). ``lapu`` may be
    None when the viscous term is absent."""
    rho = s[0]
    ext = torch.stack([torch.full_like(rho, f) for f in ext_force])
    if boussinesq == 1:
        ext = s[1] * ext
    if lapu is None:
        return ext + (-gp) / rho
    return ext + (visc_coef * visc_fac * lapu - gp) / rho


def mkvelforce_half(ext_force: Sequence[float], rho: torch.Tensor,
                    trac, gp: torch.Tensor, boussinesq: int) -> torch.Tensor:
    """mkvelforce at visc_fac = 0 with rho = rhohalf (the half-time force of
    velocity_advance.f90:86)."""
    ext = torch.stack([torch.full_like(rho, f) for f in ext_force])
    if boussinesq == 1:
        ext = trac * ext
    return ext - gp / rho


def mkscalforce(ext_force, laps: torch.Tensor, diff_coef: float,
                diff_fac: float) -> torch.Tensor:
    """Scalar forcing: ext + diff_fac*diff_coef*laps for tracers; density
    (comp 0) gets none (reference mkscalforce, src/mkforce.f90:291-334).
    ``ext_force`` may be None (statically zero)."""
    out = diff_coef * diff_fac * laps
    if ext_force is not None:
        out = ext_force + out
    out[0] = 0.0
    return out


def make_at_halftime(rho_old: torch.Tensor, rho_new: torch.Tensor) -> torch.Tensor:
    """(reference make_at_halftime.f90:73-115)"""
    return 0.5 * (rho_old + rho_new)


def estdt(u: torch.Tensor, rho: torch.Tensor, gp: torch.Tensor,
          ext_force: Sequence[float], dx: Sequence[float], dtold: float,
          cflfac: float, max_dt_growth: float, level_max=None) -> float:
    """CFL + forcing dt estimate (reference estdt, src/estdt.f90:15-183).
    Returns a host float: the step loop needs it on the host anyway.
    ``level_max`` (on a rank's block of a decomposed level) takes the
    elementwise maxima of the block's per-axis maxima over the ranks: the
    reference's parallel_reduce MPI_MAX (estdt.f90:69), exact."""
    dm = u.shape[0]
    eps = 1.0e-8
    big = 1.0e20
    umax = torch.stack([u[d].abs().max() for d in range(dm)])
    fmax = torch.stack([(gp[d] / rho - ext_force[d]).abs().max()
                        for d in range(dm)])
    if level_max is not None:
        umax, fmax = level_max(torch.stack([umax, fmax]))
    umax, fmax = umax.tolist(), fmax.tolist()
    dt = big
    for d in range(dm):
        if umax[d] > eps:
            dt = min(dt, dx[d] / umax[d])
        if fmax[d] > eps:
            dt = min(dt, (2.0 * dx[d] / fmax[d]) ** 0.5)
    if dt == big:
        dt = min(dx)
    dt = dt * cflfac
    if dtold > 0.0:
        dt = min(dt, max_dt_growth * dtold)
    return dt


def vorticity(u_pad: torch.Tensor, dx: Sequence[float], ng: int,
              n_cell: Sequence[int], phys_bc=None) -> torch.Tensor:
    """Vorticity (its magnitude in 3-D) from a ghost-padded velocity
    (reference make_vorticity, src/makevort.f90:16-56).

    With ``phys_bc``, tangential derivatives at INLET / NO_SLIP_WALL (and,
    in 2-D, SLIP_WALL) boundaries use the reference's one-sided stencils:
    2-D  (f_{+1} + 3 f_0 - 4 f_{-1}) / dx      (makevort.f90:107-138)
    3-D  (f_{+1} + 3 f_0 - 4 f_{-1}) / (3 dx)  (makevort.f90:561-607)
    (the differing 2-D/3-D normalizations are the reference's own); without
    it, pure centred differences."""
    from ..config import INLET, NO_SLIP_WALL, SLIP_WALL
    dm = u_pad.shape[0]

    def shifted(f, d, off):
        for t in range(dm):
            ax = f.ndim - dm + t
            start = ng + (off if t == d else 0)
            f = f.narrow(ax, start, n_cell[t])
        return f

    fix_codes = ((INLET, NO_SLIP_WALL, SLIP_WALL) if dm == 2
                 else (INLET, NO_SLIP_WALL))
    onesided_div = dx if dm == 2 else [3.0 * h for h in dx]

    def d_ax(f, d):
        fp, f0, fm = shifted(f, d, 1), shifted(f, d, 0), shifted(f, d, -1)
        cen = (fp - fm) / (2.0 * dx[d])
        if phys_bc is None:
            return cen
        lo_fix = phys_bc[d][0] in fix_codes
        hi_fix = phys_bc[d][1] in fix_codes
        if not (lo_fix or hi_fix):
            return cen
        ax = cen.ndim - dm + d
        idx = torch.arange(n_cell[d], device=cen.device).reshape(
            [-1 if t == ax else 1 for t in range(cen.ndim)])
        out = cen
        if lo_fix:
            lo_val = (fp + 3.0 * f0 - 4.0 * fm) / onesided_div[d]
            out = torch.where(idx == 0, lo_val, out)
        if hi_fix:
            hi_val = -(fm + 3.0 * f0 - 4.0 * fp) / onesided_div[d]
            out = torch.where(idx == n_cell[d] - 1, hi_val, out)
        return out

    if dm == 2:
        return d_ax(u_pad[1], 0) - d_ax(u_pad[0], 1)
    wx = d_ax(u_pad[2], 1) - d_ax(u_pad[1], 2)
    wy = d_ax(u_pad[0], 2) - d_ax(u_pad[2], 0)
    wz = d_ax(u_pad[1], 0) - d_ax(u_pad[0], 1)
    return torch.sqrt(wx ** 2 + wy ** 2 + wz ** 2)


def magvel(u: torch.Tensor) -> torch.Tensor:
    """(reference make_magvel, src/makevort.f90:58-91)"""
    return torch.sqrt((u * u).sum(dim=0))
