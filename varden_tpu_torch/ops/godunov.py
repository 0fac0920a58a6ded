"""Riemann upwinding helpers shared by the Godunov predictors (counterpart of
the helpers of varden_tpu.ops.godunov; reference src/velpred.f90,
src/mkflux.f90). The 2-D predictor is not ported yet.

Face-array convention: an x-face value for the face between cells i-1 and i
is stored at padded cell coordinate i ("cell-aligned" faces; the physical
face range along x is [ng, ng+nx]).
"""
from __future__ import annotations

import torch

ABS_EPS = 1.0e-8  # velpred.f90:204 / mkflux.f90:238


def _riemann_normal(l, r, eps):
    """Normal-velocity Riemann upwind (velpred.f90:310-316)."""
    uavg = 0.5 * (l + r)
    test = ((l <= 0.0) & (r >= 0.0)) | ((l + r).abs() < eps)
    sel = torch.where(uavg > 0.0, l, r)
    return torch.where(test, torch.zeros_like(sel), sel)


def _riemann_transverse(l, r, adv, eps):
    """Upwind a transverse/scalar state by advection velocity ``adv``
    (velpred.f90:318-321, mkflux.f90:371-376)."""
    sel = torch.where(adv > 0.0, l, r)
    return torch.where(adv.abs() > eps, sel, 0.5 * (l + r))


def mac_wins(mac_pads, ng, n_cell):
    """The valid region of each padded cell-aligned MAC tensor: faces
    [ng, ng+n+1) along its own axis, cells [ng-1, ng+n+1) tangentially (one
    valid tangential ghost). Returns the cropped views."""
    dm = len(mac_pads)
    out = []
    for d in range(dm):
        sl = tuple(slice(ng, ng + n_cell[t] + 1) if t == d
                   else slice(ng - 1, ng + n_cell[t] + 1) for t in range(dm))
        out.append(mac_pads[d][sl])
    return out
