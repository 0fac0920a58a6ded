"""MAC and nodal (hg) projections and the viscous solves, single level
(counterpart of varden_tpu.projection).

  * macproject  — reference src/macproject.f90:20-133 (divumac :137-225,
                  mk_mac_coeffs :280-401, mkumac :403-645)
  * hgproject   — reference src/hgproject.f90:17-177 (create_uvec :374-513,
                  mkgphi :517-577, hg_update :581-698)
  * visc_solve / diff_scalar_solve — reference src/viscsolve.f90:19-513
  * get_explicit_diffusive_term — reference
                  src/explicit_diffusive_term.f90:16-88
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
        abs_eps=-1.0, return_info=True, bottom=sim.mg_bottom, dec=sim.dec)

    # subtract beta * grad(phi) on every face; the BC-aware ghost pad makes
    # the 2-point difference realize the one-sided boundary gradient
    # (mkumac, macproject.f90:533-581)
    phi_p = mg._pad_ghost(phi, ell_bc, [[0.0, 0.0]] * dm, dm, dec=sim.dec)
    new_umac = tuple(
        umac[d] - beta[d] * (_face_diff(phi_p, d, dm, lambda h, l: h - l)
                             / dx[d])
        for d in range(dm))
    div_after = basic.mac_div(new_umac, dx)
    if mac_rhs is not None:
        div_after = div_after - mac_rhs
    return (new_umac, mg._gmax(div_before, sim.dec),
            mg._gmax(div_after, sim.dec), phi, mac_rn, mac_ratio)


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
    rhs = nodal.divu_rhs(vel, dx, pmask, dm, inflow_pad=_inflow_pad(sim),
                         dec=sim.dec)
    phi, (hg_rn, _iters, hg_ratio) = nodal.solve(
        n, dx, pmask, sigma, rhs, mask=mask, phi0=phi0, rel_eps=rel_eps,
        abs_eps=abs_eps, return_info=True, bottom=sim.hg_bottom, dec=sim.dec)
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


def _grad_cc(f_pad1, d, dm, dx_d):
    """Centered cell gradient from a 1-ghost padded scalar."""
    q = mg._interior(f_pad1, dm, skip=d)
    axis = q.ndim - dm + d
    n = q.shape[axis]
    return (q.narrow(axis, 2, n - 2) - q.narrow(axis, 0, n - 2)) / (2.0 * dx_d)


def comp_bc(sim: Sim, comp: int):
    """Elliptic BC codes and boundary values of one variable, per axis."""
    dm = sim.dm
    ell = [tuple(sim.ell_bc[comp][t]) for t in range(dm)]
    bv = [[sim.bvals[comp][t][s] for s in range(2)] for t in range(dm)]
    return ell, bv


def visc_solve(sim: Sim, unew: torch.Tensor, lapu: Optional[torch.Tensor],
               rho: torch.Tensor, mac_rhs: Optional[torch.Tensor],
               visc_mu: float, diffusion_type: int,
               rel_eps: Optional[float] = None, return_info: bool = False):
    """Per-component Helmholtz solve (rho - div mu grad) u = rhs
    (reference visc_solve, src/viscsolve.f90:19-145; RHS at :194-304).

    visc_mu is dt*mu/2 (Crank-Nicolson, diffusion_type 1, which reads lapu)
    or dt*mu (backward Euler), as set by velocity_advance. mac_rhs None
    means statically zero: its (1/3) mu dt grad(divu) term
    (viscsolve.f90:227-239) is then skipped. With return_info, returns
    (u, (resnorm, V-cycles, ratio)) as mg.solve does: the worst residual
    and ratio and the sum of the cycles over the solves it made."""
    dm, dx, n = sim.dm, sim.dx, sim.n_cell
    rel_eps = sim.eps(1.0e-12 if rel_eps is None else rel_eps)
    visc_mu_dt = 2.0 * visc_mu if diffusion_type == 1 else visc_mu
    mac_rhs_p = None if mac_rhs is None else sim.fill_extrap(mac_rhs, 1)

    rhs_list = []
    for d in range(dm):
        rh = unew[d] * rho
        if diffusion_type == 1:
            rh = rh + visc_mu * lapu[d]
        if mac_rhs_p is not None:
            rh = rh + (1.0 / 3.0) * visc_mu_dt * _grad_cc(mac_rhs_p, d, dm,
                                                          dx[d])
        rhs_list.append(rh)

    # constant coefficient: beta stays a number per axis, so the solver
    # takes its constant-stencil kernel and makes no face tensors
    beta = (visc_mu,) * dm
    kw = dict(alpha=1.0, rel_eps=rel_eps, abs_eps=-1.0, bottom=sim.mg_bottom,
              return_info=True, dec=sim.dec)
    bcs = [comp_bc(sim, d) for d in range(dm)]
    if all(b == bcs[0] for b in bcs[1:]):
        # one operator for all components (e.g. no-slip walls): one batched
        # solve, one smoothing loop and one tolerance test over the batch
        ell_bc, bvals = bcs[0]
        phi, info = mg.solve(n, dx, ell_bc, rho, beta, torch.stack(rhs_list),
                             bvals=bvals, phi0=unew, **kw)
        return (phi, info) if return_info else phi
    out, infos = [], []
    for d in range(dm):
        ell_bc, bvals = bcs[d]
        phi, info = mg.solve(n, dx, ell_bc, rho, beta, rhs_list[d],
                             bvals=bvals, phi0=unew[d], **kw)
        out.append(phi)
        infos.append(info)
    phi = torch.stack(out)
    if not return_info:
        return phi
    rns, its, ratios = zip(*infos)
    return phi, (torch.stack(rns).max(), sum(its), torch.stack(ratios).max())


def diff_scalar_solve(sim: Sim, snew: torch.Tensor,
                      laps: Optional[torch.Tensor], visc_mu: float,
                      diffusion_type: int,
                      rel_eps: Optional[float] = None) -> torch.Tensor:
    """Tracer diffusion solve (1 - div mu grad) s = rhs for comps >= 1
    (reference diff_scalar_solve, src/viscsolve.f90:308-424)."""
    dm, dx, n = sim.dm, sim.dx, sim.n_cell
    rel_eps = sim.eps(1.0e-12 if rel_eps is None else rel_eps)
    aco = torch.ones(n, dtype=sim.dtype, device=sim.device)
    out = [snew[0]]
    for i in range(1, snew.shape[0]):
        rh = snew[i]
        if diffusion_type == 1:
            rh = rh + visc_mu * laps[i]
        ell_bc, bvals = comp_bc(sim, sim.scal_comp(i))
        phi, _ = mg.solve(n, dx, ell_bc, aco, (visc_mu,) * dm, rh, alpha=1.0,
                          bvals=bvals, phi0=snew[i], rel_eps=rel_eps,
                          abs_eps=-1.0, bottom=sim.mg_bottom, dec=sim.dec)
        out.append(phi)
    return torch.stack(out)


def get_explicit_diffusive_term(sim: Sim, f: torch.Tensor,
                                comp: int) -> torch.Tensor:
    """lap(f) for one variable with its elliptic BCs (reference
    get_explicit_diffusive_term, src/explicit_diffusive_term.f90:16-88)."""
    ell_bc, bvals = comp_bc(sim, comp)
    return mg.laplacian(f, sim.n_cell, sim.dx, ell_bc, bvals, dec=sim.dec)
