"""Monotonicity-limited slopes (orders 0/2/4) with one-sided boundary stencils
(counterpart of varden_tpu.ops.slopes; reference src/slope.f90:148-588).

Full-array form: the input is a ghost-padded tensor and so is the result.
``shift(f, axis, n)`` reads f at i+n (periodic roll), so values within two
cells of the padded edge are garbage; every caller crops to a region whose
dependency cone stays inside the valid data (ng=3 suffices exactly).
"""
from __future__ import annotations

import torch

from ..bc import EXT_DIR, HOEXTRAP


def shift(f: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """out[..., i, ...] = f[..., i+n, ...] along ``axis`` (wrapping)."""
    return torch.roll(f, -n, dims=axis) if n else f


def plane(f: torch.Tensor, axis: int, i: int) -> torch.Tensor:
    """The size-1 slab at index ``i`` along ``axis`` (keepdims)."""
    sl = [slice(None)] * f.ndim
    sl[axis] = slice(i, i + 1)
    return f[tuple(sl)]


def set_plane(f: torch.Tensor, axis: int, i: int, val) -> torch.Tensor:
    """A copy of f with the plane at index ``i`` along ``axis`` set to val."""
    out = f.clone()
    sl = [slice(None)] * f.ndim
    sl[axis] = slice(i, i + 1)
    out[tuple(sl)] = val
    return out


def mc_limit(dpls, dmin, cen):
    slim = torch.minimum(dpls.abs(), dmin.abs())
    slim = torch.where(dpls * dmin > 0.0, slim, torch.zeros_like(slim))
    return torch.sign(cen) * torch.minimum(slim, cen.abs()), slim


def slope(s: torch.Tensor, axis: int, ng: int, bc_lo: int, bc_hi: int,
          order: int, n_interior: int) -> torch.Tensor:
    """Limited slope of padded tensor ``s`` along tensor axis ``axis``;
    ``ng`` ghosts along it (interior cells at [ng, ng+n_interior))."""
    if order == 0:
        return torch.zeros_like(s)
    sp = shift(s, axis, 1)
    sm = shift(s, axis, -1)
    cen = 0.5 * (sp - sm)
    dpls = 2.0 * (sp - s)
    dmin = 2.0 * (s - sm)
    if order == 2:
        sl, _ = mc_limit(dpls, dmin, cen)
    elif order == 4:
        fromm, lim = mc_limit(dpls, dmin, cen)
        flag = torch.sign(cen)
        ds = (4.0 / 3.0) * cen - (1.0 / 6.0) * (shift(fromm, axis, 1) +
                                                shift(fromm, axis, -1))
        sl = flag * torch.minimum(ds.abs(), lim)
    else:
        raise ValueError(f"slope_order must be 0/2/4, got {order}")

    # one-sided treatment on the boundary planes (slope.f90:190-216,
    # 243-283): ghost just outside -> 0, first interior -> one-sided
    # formula, second interior (order 4) -> recomputed with the revised
    # boundary slope as its Fromm neighbour
    def one_sided(sgn, sl_cur):
        i0 = ng if sgn > 0 else ng + n_interior - 1
        s0, s1 = plane(s, axis, i0), plane(s, axis, i0 + sgn)
        s2, sg = plane(s, axis, i0 + 2 * sgn), plane(s, axis, i0 - sgn)
        if order == 2:
            cen_b = sgn * (s1 + 3.0 * s0 - 4.0 * sg) / 3.0
        else:
            cen_b = sgn * (-(16.0 / 15.0) * sg + 0.5 * s0 +
                           (2.0 / 3.0) * s1 - 0.1 * s2)
        d_out = 2.0 * sgn * (s0 - sg)
        d_in = 2.0 * sgn * (s1 - s0)
        sl_b, _ = mc_limit(d_in, d_out, cen_b)
        sl_cur = set_plane(sl_cur, axis, i0 - sgn, 0.0)
        sl_cur = set_plane(sl_cur, axis, i0, sl_b)
        if order == 4:
            i2 = i0 + sgn
            ds2 = (4.0 / 3.0) * plane(cen, axis, i2) - (1.0 / 6.0) * (
                plane(fromm, axis, i2 + sgn) + sl_b)
            sl2 = plane(flag, axis, i2) * torch.minimum(ds2.abs(),
                                                        plane(lim, axis, i2))
            sl_cur = set_plane(sl_cur, axis, i2, sl2)
        return sl_cur

    if bc_lo in (EXT_DIR, HOEXTRAP):
        sl = one_sided(+1, sl)
    if bc_hi in (EXT_DIR, HOEXTRAP):
        sl = one_sided(-1, sl)
    return sl


# The debug oracle's slope (varden_tpu.ops.slopes.slope_ref and its
# _mc_limit_ref: the original full-array roll formulation). slope above is
# already that formulation, step for step, so the oracle takes it as it is.
slope_ref = slope
_mc_limit_ref = mc_limit
