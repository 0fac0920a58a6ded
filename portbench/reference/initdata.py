"""The initial data of the benchmark's configurations, made on the device in
float64: VARDEN's initdata.f90 for prob_type 1 (the density bubble) and 3
(Rayleigh-Taylor), with the velocity at rest and gp = p = 0. The port and
the reference are both handed these tensors."""
from __future__ import annotations

import math

import torch


def cell_axes(n_cell, lo_idx, dx, prob_lo, device):
    """Cell-centre coordinates along each axis (float64, on ``device``)."""
    return [prob_lo[d] + dx[d] * (lo_idx[d] + 0.5 + torch.arange(
        n_cell[d], dtype=torch.float64, device=device))
        for d in range(len(n_cell))]


def _grid(axes):
    return torch.meshgrid(*axes, indexing="ij")


def _interface_h(x, length):
    return (0.02 * torch.sin(4.0 * math.pi * x * length)
            + 0.01 * torch.sin(8.0 * math.pi * x * length))


def geometry(kw):
    """(n_cell, dx, prob_lo, prob_hi, pmask) of the base level of the
    VardenConfig keywords ``kw`` (3-D; VardenConfig's defaults)."""
    n = (kw["n_cellx"], kw["n_celly"], kw["n_cellz"])
    lo = tuple(kw.get(f"prob_lo_{a}", 0.0) for a in "xyz")
    hi = tuple(kw.get(f"prob_hi_{a}", 1.0) for a in "xyz")
    dx = tuple((h - l) / m for l, h, m in zip(lo, hi, n))
    pmask = tuple(kw.get(f"bc{a}_lo", 14) == -1 for a in "xyz")
    return n, dx, lo, hi, pmask


def initdata(kw, device):
    """(u, s, gp, p) of a single-level 3-D run of the VardenConfig keywords
    ``kw`` (prob_type 1 or 3), float64 on ``device``."""
    n, dx, lo, hi, pmask = geometry(kw)
    nscal = kw.get("nscal", 2)
    pt = kw["prob_type"]
    opts = dict(dtype=torch.float64, device=device)
    u = torch.zeros((3,) + n, **opts)
    s = torch.zeros((nscal,) + n, **opts)
    if pt == 1:
        # the bubble's centre and radius with no prob_lo, as initdata.f90
        x, y, z = _grid(cell_axes(n, (0, 0, 0), dx, (0.0,) * 3, device))
        dist = torch.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
        densfact = 10.0
        rho = 1.0 + 0.5 * (densfact - 1.0) * (1.0 - torch.tanh(
            30.0 * (dist - 0.1)))
        s[0] = rho
        if nscal > 1:
            s[1] = rho
    elif pt == 3:
        ax = cell_axes(n, (0, 0, 0), dx, lo, device)
        length = hi[0] - lo[0]
        hperp = (_interface_h(ax[0], length)[:, None, None]
                 + _interface_h(ax[1], length)[None, :, None])
        s[0] = 1.5 + 0.5 * torch.tanh((ax[2][None, None, :] - 0.5 - hperp)
                                      / 0.01)
    else:
        raise ValueError(f"no initial data for prob_type {pt}")
    node = tuple(m if p else m + 1 for m, p in zip(n, pmask))
    return u, s, torch.zeros((3,) + n, **opts), torch.zeros(node, **opts)
