"""The Godunov kernels' plain PyTorch versions (the port's
ops/cuda_godunov.py with every wrapper reduced to its plain version, on
any device): velpred_3d_fused, mkflux_update_3d_fused, mkflux_3d_fused,
velpred_2d_fused and mkflux_2d_fused, each the godunov / godunov3d
functions it stands for."""
from __future__ import annotations

import torch

from . import godunov, godunov3d
from .basic import update_plain


def _flat_bc(phys_bc, adv_bc, dm=3):
    iv = [int(phys_bc[a][s]) for a in range(dm) for s in range(2)]
    iv += [int(adv_bc[c][a][s]) for c in range(len(adv_bc))
           for a in range(dm) for s in range(2)]
    return iv


def _padded(n_cell, ng):
    return tuple(s + 2 * ng for s in n_cell)


# ---------------------------------------------------------------------------
# velpred
# ---------------------------------------------------------------------------

def _eps(umax):
    return None if umax is None else godunov._eps_from(umax)


def _umax_buf(umax, opts):
    """The kernels' running max|velocity|: zero, or the level's."""
    if umax is None:
        return torch.zeros(1, **opts)
    return umax.reshape(1).to(**opts).clone()


def velpred_3d_plain(u, force, dt, dx, phys_bc, adv_bc_vel, ng, n_cell,
                     slope_order, use_minion, umax=None):
    """The plain PyTorch version of velpred_3d_fused."""
    return godunov3d.velpred_3d(u, force, dt, dx, phys_bc, adv_bc_vel, ng,
                                n_cell, slope_order, use_minion,
                                eps=_eps(umax))


def velpred_3d_fused(u, force, dt, dx, phys_bc, adv_bc_vel, ng, n_cell,
                     slope_order, use_minion, umax=None):
    """Corner-coupled BCG MAC predictor. u, force: (3, *padded) with ng
    ghosts. Returns interior (umac, vmac, wmac) exactly as
    godunov3d.velpred_3d, at any extent and in both dtypes. On the card:
    two launches, the tie epsilon and one shared-memory brick pass."""
    return velpred_3d_plain(u, force, dt, dx, phys_bc, adv_bc_vel, ng,
                            n_cell, slope_order, use_minion, umax)


velpred_3d_fused.launches = 0


# ---------------------------------------------------------------------------
# fused mkflux + update
# ---------------------------------------------------------------------------

def _mac_interior(macs, ng, n_cell):
    """Interior MAC faces from the cell-aligned padded tensors."""
    return [macs[d][tuple(slice(ng, ng + n_cell[t] + (1 if t == d else 0))
                          for t in range(3))] for d in range(3)]


def mkflux_update_3d_plain(s, mac_pads, force, fupd, mac_rhs, dt, dx,
                           phys_bc, adv_bc, ng, n_cell, is_vel,
                           is_conservative, slope_order, use_minion, *,
                           flux_comps=(), umax=None):
    """The plain PyTorch version of mkflux_update_3d_fused."""
    sedge, sflux = godunov3d.mkflux_3d(
        s, mac_pads, force, mac_rhs, dt, dx, phys_bc, adv_bc, ng, n_cell,
        is_vel, is_conservative, slope_order, use_minion, eps=_eps(umax))
    umac = _mac_interior(mac_pads, ng, n_cell)
    sold = s[(slice(None),) + tuple(slice(ng, ng + n_cell[t])
                                    for t in range(3))]
    snew = update_plain(sold, umac, sedge, sflux, fupd, dt, dx,
                        is_conservative)
    if not flux_comps:
        return snew
    return snew, tuple(f[list(flux_comps)] for f in sflux)


def mkflux_update_3d_fused(s, mac_pads, force, fupd, mac_rhs, dt, dx,
                           phys_bc, adv_bc, ng, n_cell, is_vel,
                           is_conservative, slope_order, use_minion, *,
                           flux_comps=(), umax=None):
    """Fused mkflux + conservative/convective update. ``fupd`` is the
    interior (nc, *n) update-time force; returns snew (nc, *n_cell).

    ``flux_comps``: the components whose conservative fluxes the AMR flux
    registers read; when non-empty, returns (snew, sflux) with sflux[d] of
    shape (len(flux_comps), faces), equal to godunov3d.mkflux_3d's
    sflux[d][flux_comps] (zero for a convective component).

    ``force``, ``fupd`` and ``mac_rhs`` may each be None, meaning
    statically zero: never read and never allocated."""
    flux_comps = tuple(flux_comps)
    return mkflux_update_3d_plain(s, mac_pads, force, fupd, mac_rhs, dt,
                                  dx, phys_bc, adv_bc, ng, n_cell, is_vel,
                                  is_conservative, slope_order,
                                  use_minion, flux_comps=flux_comps,
                                  umax=umax)


mkflux_update_3d_fused.launches = 0


def mkflux_3d_plain(s, mac_pads, force, mac_rhs, dt, dx, phys_bc, adv_bc,
                    ng, n_cell, is_vel, is_conservative, slope_order,
                    use_minion, umax=None):
    """The plain PyTorch version of mkflux_3d_fused."""
    return godunov3d.mkflux_3d(s, mac_pads, force, mac_rhs, dt, dx, phys_bc,
                               adv_bc, ng, n_cell, is_vel, is_conservative,
                               slope_order, use_minion, eps=_eps(umax))


def mkflux_3d_fused(s, mac_pads, force, mac_rhs, dt, dx, phys_bc, adv_bc,
                    ng, n_cell, is_vel, is_conservative, slope_order,
                    use_minion, umax=None):
    """Godunov edge states and fluxes of nc components on all three face
    sets: returns (sedge, sflux), tuples of three (nc, faces) tensors,
    exactly as godunov3d.mkflux_3d, at any extent and in both dtypes.
    ``force`` and ``mac_rhs`` may each be None, meaning statically zero:
    never read and never allocated. On the card: two launches, the tie
    epsilon and one shared-memory brick pass."""
    return mkflux_3d_plain(s, mac_pads, force, mac_rhs, dt, dx, phys_bc,
                           adv_bc, ng, n_cell, is_vel, is_conservative,
                           slope_order, use_minion, umax)


mkflux_3d_fused.launches = 0


# ---------------------------------------------------------------------------
# 2-D: velpred, and mkflux (edge states and fluxes, no update)
# ---------------------------------------------------------------------------

def velpred_2d_plain(u, force, dt, dx, phys_bc, adv_bc_vel, ng, n_cell,
                     slope_order, use_minion, umax=None):
    """The plain PyTorch version of velpred_2d_fused."""
    return godunov.velpred_2d(u, force, dt, dx, phys_bc, adv_bc_vel, ng,
                              n_cell, slope_order, use_minion,
                              eps=_eps(umax))


def velpred_2d_fused(u, force, dt, dx, phys_bc, adv_bc_vel, ng, n_cell,
                     slope_order, use_minion, umax=None):
    """BCG MAC predictor, 2-D. u, force: (2, nx+2ng, ny+2ng). Returns
    interior (umac (nx+1, ny), vmac (nx, ny+1)) exactly as
    godunov.velpred_2d, at any size and in both dtypes. On the card: two
    launches, the tie epsilon and one shared-memory tile pass."""
    return velpred_2d_plain(u, force, dt, dx, phys_bc, adv_bc_vel, ng,
                            n_cell, slope_order, use_minion, umax)


velpred_2d_fused.launches = 0


def mkflux_2d_plain(s, umac_pad, vmac_pad, force, mac_rhs, dt, dx, phys_bc,
                    adv_bc, ng, n_cell, is_vel, is_conservative, slope_order,
                    use_minion, umax=None):
    """The plain PyTorch version of mkflux_2d_fused."""
    return godunov.mkflux_2d(s, umac_pad, vmac_pad, force, mac_rhs, dt, dx,
                             phys_bc, adv_bc, ng, n_cell, is_vel,
                             is_conservative, slope_order, use_minion,
                             eps=_eps(umax))


def mkflux_2d_fused(s, umac_pad, vmac_pad, force, mac_rhs, dt, dx, phys_bc,
                    adv_bc, ng, n_cell, is_vel, is_conservative, slope_order,
                    use_minion, umax=None):
    """Godunov edge states and fluxes of nc components, 2-D: returns
    (sedgex, sedgey, fluxx, fluxy) exactly as godunov.mkflux_2d, at any size
    and in both dtypes. ``force`` and ``mac_rhs`` may each be None, meaning
    statically zero: never read and never allocated. On the card: two
    launches, the tie epsilon and one shared-memory tile pass."""
    return mkflux_2d_plain(s, umac_pad, vmac_pad, force, mac_rhs, dt, dx,
                           phys_bc, adv_bc, ng, n_cell, is_vel,
                           is_conservative, slope_order, use_minion, umax)


mkflux_2d_fused.launches = 0
