"""Hand-written CUDA kernels for the Godunov hot loops (counterpart of
varden_tpu.ops.pallas_godunov).

  velpred_3d_fused        csrc/velpred.cu        = godunov3d.velpred_3d
  mkflux_update_3d_fused  csrc/mkflux_update.cu  = godunov3d.mkflux_3d
                                                   followed by
                                                   basic.update_plain (and
                                                   the listed fluxes)
  mkflux_3d_fused         csrc/mkflux.cu         = godunov3d.mkflux_3d
  velpred_2d_fused        csrc/velpred2d.cu      = godunov.velpred_2d
  mkflux_2d_fused         csrc/mkflux2d.cu       = godunov.mkflux_2d

Each wrapper takes the same arguments as its TPU counterpart. On a CPU
tensor it runs its plain PyTorch version (``*_plain`` below); on a CUDA
tensor it launches the kernel or raises. ``umax`` (every wrapper) gives the
largest |velocity| of the whole level, from which the Riemann tie epsilon
is formed, where the tensors are one rank's block of it; the kernels'
first launch then takes the larger of it and the block's own, which it is.
``<wrapper>.launches`` counts the
CUDA launches the wrapper made (every stage counts: each makes two,
the tie epsilon and one shared-memory pass).
"""
from __future__ import annotations

import torch

from . import _cuda, godunov, godunov3d
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
    if u.device.type == "cpu":
        return velpred_3d_plain(u, force, dt, dx, phys_bc, adv_bc_vel, ng,
                                n_cell, slope_order, use_minion, umax)
    return _velpred_launch(u, force, dt, dx, phys_bc, adv_bc_vel, ng, n_cell,
                           slope_order, use_minion, umax)


def _velpred_launch(u, force, dt, dx, phys_bc, adv_bc_vel, ng, n_cell,
                    slope_order, use_minion, umax=None):
    P = _padded(n_cell, ng)
    _cuda.check(u, "u", (3,) + P)
    _cuda.check(force, "force", (3,) + P, u.dtype, u.device)
    opts = dict(dtype=u.dtype, device=u.device)
    outs = [torch.empty(tuple(n_cell[t] + (1 if t == d else 0)
                              for t in range(3)), **opts) for d in range(3)]
    umax = _umax_buf(umax, opts)
    iv = [*n_cell, ng, slope_order, int(bool(use_minion))]
    iv += _flat_bc(phys_bc, adv_bc_vel)
    _cuda.call("velpred", "velpred3d", [u, force, *outs, umax], iv,
               [float(dt), *map(float, dx)], u)
    velpred_3d_fused.launches += 2
    return tuple(outs)


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
    if s.device.type == "cpu":
        return mkflux_update_3d_plain(s, mac_pads, force, fupd, mac_rhs, dt,
                                      dx, phys_bc, adv_bc, ng, n_cell, is_vel,
                                      is_conservative, slope_order,
                                      use_minion, flux_comps=flux_comps,
                                      umax=umax)
    return _mkflux_update_launch(s, mac_pads, force, fupd, mac_rhs, dt, dx,
                                 phys_bc, adv_bc, ng, n_cell, is_vel,
                                 is_conservative, slope_order, use_minion,
                                 flux_comps, umax)


def _mkflux_update_launch(s, mac_pads, force, fupd, mac_rhs, dt, dx,
                          phys_bc, adv_bc, ng, n_cell, is_vel,
                          is_conservative, slope_order, use_minion,
                          flux_comps=(), umax=None):
    flux_comps = tuple(flux_comps)
    nc = s.shape[0]
    P = _padded(n_cell, ng)
    n = tuple(n_cell)
    _cuda.check(s, "s", (nc,) + P)
    if not 1 <= nc <= 4:
        raise ValueError(f"mkflux_update_3d_fused: {nc} components (1-4)")
    kw = dict(dtype=s.dtype, device=s.device)
    for d in range(3):
        _cuda.check(mac_pads[d], f"mac_pads[{d}]", P, **kw)
    if force is not None:
        _cuda.check(force, "force", (nc,) + P, **kw)
    if mac_rhs is not None:
        _cuda.check(mac_rhs, "mac_rhs", P, **kw)
    if fupd is not None:
        _cuda.check(fupd, "fupd", (nc,) + n, **kw)
    if len(flux_comps) > 4 or any(not 0 <= c < nc for c in flux_comps):
        raise ValueError(f"mkflux_update_3d_fused: flux_comps {flux_comps} "
                         f"(at most 4 of the {nc} components)")
    snew = torch.empty((nc,) + n, **kw)
    sflux = tuple(torch.empty((len(flux_comps),) + tuple(
        n[t] + (1 if t == d else 0) for t in range(3)), **kw)
        for d in range(3)) if flux_comps else (None,) * 3
    umax = _umax_buf(umax, kw)
    cons_mask = sum(1 << c for c in range(nc) if is_conservative[c])
    iv = [*n, ng, slope_order, int(bool(use_minion)), nc, int(bool(is_vel)),
          cons_mask] + _flat_bc(phys_bc, adv_bc)
    iv += [len(flux_comps), *flux_comps]
    _cuda.call("mkflux_update", "mkflux_update3d",
               [s, *mac_pads, force, mac_rhs, fupd, snew, *sflux, umax],
               iv, [float(dt), *map(float, dx)], s)
    mkflux_update_3d_fused.launches += 2
    return (snew, sflux) if flux_comps else snew


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
    if s.device.type == "cpu":
        return mkflux_3d_plain(s, mac_pads, force, mac_rhs, dt, dx, phys_bc,
                               adv_bc, ng, n_cell, is_vel, is_conservative,
                               slope_order, use_minion, umax)
    return _mkflux3d_launch(s, mac_pads, force, mac_rhs, dt, dx, phys_bc,
                            adv_bc, ng, n_cell, is_vel, is_conservative,
                            slope_order, use_minion, umax)


def _mkflux3d_launch(s, mac_pads, force, mac_rhs, dt, dx, phys_bc, adv_bc,
                     ng, n_cell, is_vel, is_conservative, slope_order,
                     use_minion, umax=None):
    nc = s.shape[0]
    P = _padded(n_cell, ng)
    n = tuple(n_cell)
    _cuda.check(s, "s", (nc,) + P)
    if not 1 <= nc <= 4:
        raise ValueError(f"mkflux_3d_fused: {nc} components (1-4)")
    kw = dict(dtype=s.dtype, device=s.device)
    for d in range(3):
        _cuda.check(mac_pads[d], f"mac_pads[{d}]", P, **kw)
    if force is not None:
        _cuda.check(force, "force", (nc,) + P, **kw)
    if mac_rhs is not None:
        _cuda.check(mac_rhs, "mac_rhs", P, **kw)
    faces = [(nc,) + tuple(n[t] + (1 if t == d else 0) for t in range(3))
             for d in range(3)]
    sedge = tuple(torch.empty(f, **kw) for f in faces)
    sflux = tuple(torch.empty(f, **kw) for f in faces)
    umax = _umax_buf(umax, kw)
    cons_mask = sum(1 << c for c in range(nc) if is_conservative[c])
    iv = [*n, ng, slope_order, int(bool(use_minion)), nc, int(bool(is_vel)),
          cons_mask] + _flat_bc(phys_bc, adv_bc)
    _cuda.call("mkflux", "mkflux3d",
               [s, *mac_pads, force, mac_rhs, *sedge, *sflux, umax],
               iv, [float(dt), *map(float, dx)], s)
    mkflux_3d_fused.launches += 2
    return sedge, sflux


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
    if u.device.type == "cpu":
        return velpred_2d_plain(u, force, dt, dx, phys_bc, adv_bc_vel, ng,
                                n_cell, slope_order, use_minion, umax)
    return _velpred2d_launch(u, force, dt, dx, phys_bc, adv_bc_vel, ng,
                             n_cell, slope_order, use_minion, umax)


def _velpred2d_launch(u, force, dt, dx, phys_bc, adv_bc_vel, ng, n_cell,
                      slope_order, use_minion, umax=None):
    nx, ny = n_cell
    P = _padded(n_cell, ng)
    _cuda.check(u, "u", (2,) + P)
    _cuda.check(force, "force", (2,) + P, u.dtype, u.device)
    opts = dict(dtype=u.dtype, device=u.device)
    umac = torch.empty((nx + 1, ny), **opts)
    vmac = torch.empty((nx, ny + 1), **opts)
    umax = _umax_buf(umax, opts)
    iv = [nx, ny, ng, slope_order, int(bool(use_minion))]
    iv += _flat_bc(phys_bc, adv_bc_vel, 2)
    _cuda.call("velpred2d", "velpred2d", [u, force, umac, vmac, umax],
               iv, [float(dt), *map(float, dx)], u)
    velpred_2d_fused.launches += 2
    return umac, vmac


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
    if s.device.type == "cpu":
        return mkflux_2d_plain(s, umac_pad, vmac_pad, force, mac_rhs, dt, dx,
                               phys_bc, adv_bc, ng, n_cell, is_vel,
                               is_conservative, slope_order, use_minion, umax)
    return _mkflux2d_launch(s, umac_pad, vmac_pad, force, mac_rhs, dt, dx,
                            phys_bc, adv_bc, ng, n_cell, is_vel,
                            is_conservative, slope_order, use_minion, umax)


def _mkflux2d_launch(s, umac_pad, vmac_pad, force, mac_rhs, dt, dx, phys_bc,
                     adv_bc, ng, n_cell, is_vel, is_conservative, slope_order,
                     use_minion, umax=None):
    nc = s.shape[0]
    nx, ny = n_cell
    P = _padded(n_cell, ng)
    _cuda.check(s, "s", (nc,) + P)
    if not 1 <= nc <= 4:
        raise ValueError(f"mkflux_2d_fused: {nc} components (1-4)")
    kw = dict(dtype=s.dtype, device=s.device)
    _cuda.check(umac_pad, "umac_pad", P, **kw)
    _cuda.check(vmac_pad, "vmac_pad", P, **kw)
    if force is not None:
        _cuda.check(force, "force", (nc,) + P, **kw)
    if mac_rhs is not None:
        _cuda.check(mac_rhs, "mac_rhs", P, **kw)
    outs = [torch.empty(shape, **kw)
            for shape in ((nc, nx + 1, ny), (nc, nx, ny + 1)) * 2]
    umax = _umax_buf(umax, kw)
    cons_mask = sum(1 << c for c in range(nc) if is_conservative[c])
    iv = [nx, ny, ng, slope_order, int(bool(use_minion)), nc,
          int(bool(is_vel)), cons_mask] + _flat_bc(phys_bc, adv_bc, 2)
    _cuda.call("mkflux2d", "mkflux2d",
               [s, umac_pad, vmac_pad, force, mac_rhs, *outs, umax],
               iv, [float(dt), *map(float, dx)], s)
    mkflux_2d_fused.launches += 2
    return tuple(outs)


mkflux_2d_fused.launches = 0
