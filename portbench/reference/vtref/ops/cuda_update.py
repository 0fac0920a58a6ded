"""The cell update's plain PyTorch version (the port's ops/cuda_update.py
with its wrapper reduced to the plain version, on any device)."""
from __future__ import annotations

from .basic import update_plain


def update_3d_plain(sold, umac, sedge, flux, force, dt, dx, is_conservative):
    """The plain PyTorch version of update_3d."""
    return update_plain(sold, umac, sedge, flux, force, dt, dx,
                        is_conservative)


def update_3d(sold, umac, sedge, flux, force, dt, dx, is_conservative):
    """snew = sold - dt*(u·grad s | div flux) + dt*force per component,
    conservative or convective per component. sold/force: (nc, n0, n1, n2);
    umac[d]: faces (n_d + 1 along d); sedge[d]/flux[d]: (nc, faces). force
    may be None (zero); sedge (flux) may be None when every (no) component
    is conservative."""
    return update_3d_plain(sold, umac, sedge, flux, force, dt, dx,
                           is_conservative)


update_3d.launches = 0
