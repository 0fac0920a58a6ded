"""MAC and nodal (hg) projections, single level (counterpart of
varden_tpu.projection).

  * macproject  — reference src/macproject.f90:20-133 (divumac :137-225,
                  mk_mac_coeffs :280-401, mkumac :403-645)
  * hgproject   — reference src/hgproject.f90:17-177 (create_uvec :374-513,
                  mkgphi :517-577, hg_update :581-698)

The viscous and diffusive solves (visc_solve, diff_scalar_solve,
get_explicit_diffusive_term) wait for the viscous slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .config import INLET
from .ops import basic
from .solvers import mg, nodal
from .state import Sim

# Projection types (reference src/proj_parameters.f90:5-8)
INITIAL_PROJECTION = 1
DIVU_ITERS = 2
PRESSURE_ITERS = 3
REGULAR_TIMESTEP = 4


def _face_diff(q, d, dm, op):
    """op(hi, lo) of a 1-ghost padded tensor along axis d, cropped to the
    interior on the other axes."""
    q = mg._interior(q, dm, skip=d)
    axis = q.ndim - dm + d
    n = q.shape[axis]
    return op(q.narrow(axis, 1, n - 1), q.narrow(axis, 0, n - 1))


def mk_mac_coeffs(sim: Sim, rho: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """beta_d = 2/(rho_i + rho_{i-1}) on all faces including domain faces
    (uses physbc-filled rho ghosts; reference macproject.f90:339-401)."""
    rho_p = sim.fill_comp(rho, sim.scal_comp(0), 1)
    return tuple(2.0 / _face_diff(rho_p, d, sim.dm, lambda h, l: h + l)
                 for d in range(sim.dm))


def macproject(sim: Sim, umac: Tuple[torch.Tensor, ...], rho: torch.Tensor,
               mac_rhs: Optional[torch.Tensor] = None,
               rel_eps: Optional[float] = None, phi0=None):
    """Project MAC velocities onto div(umac) = mac_rhs.

    Returns (umac_projected, max|div before|, max|div after|, phi, resnorm,
    ratio); the norms are 0-d tensors. phi0 warm-starts the solve. The
    default rel_eps mirrors the reference override at macproject.f90:92.
    """
    dm, dx, n = sim.dm, sim.dx, sim.n_cell
    rel_eps = sim.eps(1.0e-10 if rel_eps is None else rel_eps)
    div_before = basic.mac_div(umac, dx)
    if mac_rhs is not None:
        div_before = div_before - mac_rhs
    # solver convention: (alpha - div beta grad) phi = rhs with alpha = 0,
    # so rhs = mac_rhs - div(umac)  (macproject.f90:186-199)
    rhs = -div_before

    beta = mk_mac_coeffs(sim, rho)
    ell_bc = [tuple(sim.ell_bc[sim.press_comp][d]) for d in range(dm)]
    aco = sim.zeros(n)
    phi, (mac_rn, _iters, mac_ratio) = mg.solve(
        n, dx, ell_bc, aco, beta, rhs, alpha=0.0, phi0=phi0, rel_eps=rel_eps,
        abs_eps=-1.0, return_info=True)

    # subtract beta * grad(phi) on every face; the BC-aware ghost pad makes
    # the 2-point difference realize the one-sided boundary gradient
    # (mkumac, macproject.f90:533-581)
    phi_p = mg._pad_ghost(phi, ell_bc, [[0.0, 0.0]] * dm, dm)
    new_umac = tuple(
        umac[d] - beta[d] * (_face_diff(phi_p, d, dm, lambda h, l: h - l)
                             / dx[d])
        for d in range(dm))
    div_after = basic.mac_div(new_umac, dx)
    if mac_rhs is not None:
        div_after = div_after - mac_rhs
    return (new_umac, div_before.abs().max(), div_after.abs().max(), phi,
            mac_rn, mac_ratio)


def _inflow_pad(sim: Sim):
    """EXT_DIR ghost velocity for the weak divergence: inflow values at INLET
    faces, zero elsewhere (create_uvec wall zeroing, hgproject.f90:424-427)."""
    def pad(comp, d, side):
        if sim.phys_bc[d][side] == INLET:
            return sim.bvals[comp][d][side]
        return 0.0
    return pad


def hgproject(sim: Sim, proj_type: int, unew: torch.Tensor,
              uold: torch.Tensor, rhohalf: torch.Tensor, p: torch.Tensor,
              gp: torch.Tensor, dt, rel_eps: Optional[float] = None,
              abs_eps: float = -1.0, phi0=None):
    """Approximate nodal projection. Returns (unew, p, gp, phi, resnorm,
    ratio); ratio = resnorm / effective tolerance (> 1 marks an
    under-converged exit). proj_type semantics follow reference
    hgproject.f90:374-430 & :581-634."""
    dm, dx, n = sim.dm, sim.dx, sim.n_cell
    pmask = sim.pmask
    rel_eps = sim.eps(1.0e-12 if rel_eps is None else rel_eps)

    # the vector field to project (create_uvec)
    if proj_type in (INITIAL_PROJECTION, DIVU_ITERS):
        vel = unew
    elif proj_type == PRESSURE_ITERS:
        vel = (unew - uold) / dt
    elif proj_type == REGULAR_TIMESTEP:
        vel = unew + dt * gp / rhohalf
    else:
        raise ValueError(f"bad proj_type {proj_type}")

    sigma = 1.0 / rhohalf
    mask = sim.nodal_mask()
    rhs = nodal.divu_rhs(vel, dx, pmask, dm, inflow_pad=_inflow_pad(sim))
    phi, (hg_rn, _iters, hg_ratio) = nodal.solve(
        n, dx, pmask, sigma, rhs, mask=mask, phi0=phi0, rel_eps=rel_eps,
        abs_eps=abs_eps, return_info=True)
    gphi = nodal.cell_grad(phi, dx, pmask, dm)

    # hg_update (hgproject.f90:581-634)
    vel = vel - gphi / rhohalf
    unew = uold + dt * vel if proj_type == PRESSURE_ITERS else vel
    if proj_type in (INITIAL_PROJECTION, DIVU_ITERS):
        gp = torch.zeros_like(gp)
        p = torch.zeros_like(p)
    elif proj_type == PRESSURE_ITERS:
        gp = gp + gphi
        p = p + phi
    else:  # REGULAR_TIMESTEP: phi held dt*pressure
        gp = gphi / dt
        p = phi / dt
    return unew, p, gp, phi, hg_rn, hg_ratio

