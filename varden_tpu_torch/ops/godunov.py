"""Unsplit BCG Godunov edge-state prediction, 2-D, and the Riemann upwinding
helpers shared with the 3-D predictors (counterpart of
varden_tpu.ops.godunov; reference velpred_2d, src/velpred.f90:125-524, and
mkflux_2d, src/mkflux.f90:152-691).

velpred_2d and mkflux_2d are the plain PyTorch form behind the two 2-D
Godunov kernels of ops/cuda_godunov.py. As in ops/godunov3d.py every
intermediate is a full ghost-padded tensor and a shift is a periodic roll,
so points near the padded edge hold garbage that the final interior crop
never reads (ng=3 bounds the dependency cone of every interior face).

Face-array convention: an x-face value for the face between cells i-1 and i
is stored at padded cell coordinate i ("cell-aligned" faces; the physical
face range along x is [ng, ng+nx]).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..config import INLET, NO_SLIP_WALL, OUTLET, PERIODIC, SLIP_WALL, SYMMETRY
from .slopes import plane, shift, slope

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


def _put(f, axis, i, val):
    """In-place: the plane at index i along axis := val."""
    sl = [slice(None)] * f.ndim
    sl[axis] = slice(i, i + 1)
    f[tuple(sl)] = val


def _eps_from(umax):
    return torch.where(umax == 0.0, torch.full_like(umax, ABS_EPS),
                       ABS_EPS * umax)


def _crop(f, a, ng, n_cell):
    """Interior faces of set ``a`` from a cell-aligned padded tensor."""
    return f[tuple(slice(ng, ng + n_cell[t] + (1 if t == a else 0))
                   for t in range(len(n_cell)))]


def _copy_inner(lv, rv, side):
    """Both states := the one from inside the domain."""
    return (rv, rv) if side == 0 else (lv, lv)


# ---------------------------------------------------------------------------
# velpred: MAC velocity prediction
# ---------------------------------------------------------------------------

def velpred_2d(u: torch.Tensor, force: torch.Tensor, dt, dx: Sequence[float],
               phys_bc, adv_bc_vel, ng: int, n_cell: Sequence[int],
               slope_order: int, use_minion: bool, eps=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, force: (2, Nx, Ny) ghost-padded. Returns interior umac (nx+1, ny)
    and vmac (nx, ny+1). ``eps`` overrides the Riemann tie epsilon."""
    dm = 2
    nx, ny = n_cell
    dt2, dt4 = 0.5 * dt, 0.25 * dt
    if eps is None:
        eps = _eps_from(u[:, ng:ng + nx, ng:ng + ny].abs().max())
    uw = [u[c] for c in range(dm)]
    fw = [force[c] for c in range(dm)]
    slopes = [[slope(u[c], a, ng, adv_bc_vel[c][a][0], adv_bc_vel[c][a][1],
                     slope_order, n_cell[a]) for c in range(dm)]
              for a in range(dm)]

    # ---- hat states on each face set (velpred.f90:258-321): 1-D normal
    # extrapolation, the physical-face overrides of :276-308, Riemann
    uls, urs, uimh = [], [], []
    for a in range(dm):
        un = uw[a]
        lo_fac = 0.5 - dt2 * un.clamp(min=0.0) / dx[a]
        hi_fac = 0.5 + dt2 * un.clamp(max=0.0) / dx[a]
        l = [shift(uw[c] + lo_fac * slopes[a][c], a, -1) for c in range(dm)]
        r = [uw[c] - hi_fac * slopes[a][c] for c in range(dm)]
        if use_minion:
            l = [l[c] + dt2 * shift(fw[c], a, -1) for c in range(dm)]
            r = [r[c] + dt2 * fw[c] for c in range(dm)]
        for side, fidx in ((0, ng), (1, ng + n_cell[a])):
            pb = phys_bc[a][side]
            if pb == PERIODIC:
                continue
            gidx = fidx - 1 if side == 0 else fidx  # ghost cell just outside
            for c in range(dm):
                lv = plane(l[c], a, fidx).clone()
                rv = plane(r[c], a, fidx).clone()
                if pb == INLET:
                    lv = rv = plane(uw[c], a, gidx)
                elif pb == SLIP_WALL:
                    if c == a:
                        lv = rv = torch.zeros_like(lv)
                    else:
                        lv, rv = _copy_inner(lv, rv, side)
                elif pb == NO_SLIP_WALL:
                    lv = rv = torch.zeros_like(lv)
                elif pb == OUTLET:
                    if c != a:
                        lv, rv = _copy_inner(lv, rv, side)
                    elif side == 0:
                        lv = rv = rv.clamp(max=0.0)
                    else:
                        lv = rv = lv.clamp(min=0.0)
                elif pb == SYMMETRY and c == a:
                    lv = rv = torch.zeros_like(lv)
                _put(l[c], a, fidx, lv)
                _put(r[c], a, fidx, rv)
        normal = _riemann_normal(l[a], r[a], eps)
        hat = [None] * dm
        hat[a] = normal
        hat[1 - a] = _riemann_transverse(l[1 - a], r[1 - a], normal, eps)
        uls.append(l)
        urs.append(r)
        uimh.append(hat)

    # ---- full states: the transverse correction (velpred.f90:402-498),
    # the force, Riemann, and the face values the BCs fix
    macs = []
    for a in range(dm):
        t = 1 - a
        ht, dh = uimh[t][t], uimh[t][a]
        corr = (dt4 / dx[t]) * (ht + shift(ht, t, 1)) * (shift(dh, t, 1) - dh)
        macl = uls[a][a] - shift(corr, a, -1)
        macr = urs[a][a] - corr
        if not use_minion:
            macl = macl + dt2 * shift(fw[a], a, -1)
            macr = macr + dt2 * fw[a]
        mac = _riemann_normal(macl, macr, eps)
        for side, fidx in ((0, ng), (1, ng + n_cell[a])):
            pb = phys_bc[a][side]
            if pb in (SLIP_WALL, NO_SLIP_WALL, SYMMETRY):
                val = 0.0
            elif pb == INLET:
                val = plane(uw[a], a, fidx - 1 if side == 0 else fidx)
            elif pb == OUTLET:
                val = (plane(macr, a, fidx).clamp(max=0.0) if side == 0
                       else plane(macl, a, fidx).clamp(min=0.0))
            else:
                continue
            _put(mac, a, fidx, val)
        macs.append(mac)
    return tuple(_crop(macs[a], a, ng, n_cell) for a in range(dm))


# ---------------------------------------------------------------------------
# mkflux: edge states / fluxes for cell-centered quantities
# ---------------------------------------------------------------------------

def mkflux_2d(s: torch.Tensor, umac_pad: torch.Tensor, vmac_pad: torch.Tensor,
              force, mac_rhs, dt, dx: Sequence[float], phys_bc, adv_bc,
              ng: int, n_cell: Sequence[int], is_vel: bool,
              is_conservative: Sequence[bool], slope_order: int,
              use_minion: bool, eps=None):
    """Godunov edge states and conservative fluxes on both face sets.

    s, force: (nc, Nx, Ny) ghost-padded; mac_rhs: (Nx, Ny) padded;
    umac_pad/vmac_pad: cell-aligned padded MAC faces with one valid
    tangential ghost. force and mac_rhs may be None (statically zero: their
    terms are skipped). Returns interior sedgex (nc, nx+1, ny), sedgey
    (nc, nx, ny+1), fluxx, fluxy (zero for non-conservative components).
    ``eps`` overrides the Riemann tie epsilon."""
    dm = 2
    nx, ny = n_cell
    nc = s.shape[0]
    dt2, dt4 = 0.5 * dt, 0.25 * dt
    macw = (umac_pad, vmac_pad)
    if eps is None:
        eps = _eps_from(torch.maximum(
            _crop(umac_pad, 0, ng, n_cell).abs().max(),
            _crop(vmac_pad, 1, ng, n_cell).abs().max()))
    slopes = [[slope(s[c], a, ng, adv_bc[c][a][0], adv_bc[c][a][1],
                     slope_order, n_cell[a]) for c in range(nc)]
              for a in range(dm)]

    sedge = [[], []]
    sflux = [[], []]
    for c in range(nc):
        sc = s[c]
        fc = force[c] if force is not None else None
        cons = is_conservative[c]
        # the divu source of a conservative component
        src = sc * mac_rhs if cons and mac_rhs is not None else None

        # ---- hat states (mkflux.f90:299-376)
        sls, srs, simh = [], [], []
        for a in range(dm):
            adv, sl_a = macw[a], slopes[a][c]
            l = shift(sc + 0.5 * sl_a, a, -1) - (dt2 / dx[a]) * adv * \
                shift(sl_a, a, -1)
            r = sc - (0.5 + dt2 * adv / dx[a]) * sl_a
            if use_minion and fc is not None:
                l = l + dt2 * shift(fc, a, -1)
                r = r + dt2 * fc
            if use_minion and src is not None:
                l = l - dt2 * shift(src, a, -1)
                r = r - dt2 * sc * mac_rhs
            for side, fidx in ((0, ng), (1, ng + n_cell[a])):
                pb = phys_bc[a][side]
                if pb == PERIODIC:
                    continue
                lv = plane(l, a, fidx).clone()
                rv = plane(r, a, fidx).clone()
                normal_vel = is_vel and c == a
                if pb == INLET:
                    lv = rv = plane(sc, a, fidx - 1 if side == 0 else fidx)
                elif pb in (SLIP_WALL, SYMMETRY):
                    if normal_vel:
                        lv = rv = torch.zeros_like(lv)
                    else:
                        lv, rv = _copy_inner(lv, rv, side)
                elif pb == NO_SLIP_WALL:
                    if is_vel:
                        lv = rv = torch.zeros_like(lv)
                    else:
                        lv, rv = _copy_inner(lv, rv, side)
                elif pb == OUTLET:
                    if not normal_vel:
                        lv, rv = _copy_inner(lv, rv, side)
                    elif side == 0:
                        lv = rv = rv.clamp(max=0.0)
                    else:
                        lv = rv = lv.clamp(min=0.0)
                _put(l, a, fidx, lv)
                _put(r, a, fidx, rv)
            sls.append(l)
            srs.append(r)
            simh.append(_riemann_transverse(l, r, adv, eps))

        # ---- transverse-corrected edge states (mkflux.f90:470-505,
        # 573-601), Riemann, boundary overrides (:508-553, 604-651)
        for a in range(dm):
            t = 1 - a
            a_lo, a_hi = macw[t], shift(macw[t], t, 1)
            h_lo, h_hi = simh[t], shift(simh[t], t, 1)
            if cons:
                corr = (dt2 / dx[t]) * (h_hi * a_hi - h_lo * a_lo) \
                    - (dt2 / dx[t]) * sc * (a_hi - a_lo)
            else:
                corr = (dt4 / dx[t]) * (a_lo + a_hi) * (h_hi - h_lo)
            el = sls[a] - shift(corr, a, -1)
            er = srs[a] - corr
            if (not use_minion) and fc is not None:
                el = el + dt2 * shift(fc, a, -1)
                er = er + dt2 * fc
            if (not use_minion) and src is not None:
                el = el - dt2 * shift(src, a, -1)
                er = er - dt2 * sc * mac_rhs
            edge = _riemann_transverse(el, er, macw[a], eps)
            for side, fidx in ((0, ng), (1, ng + n_cell[a])):
                pb = phys_bc[a][side]
                inner = plane(er if side == 0 else el, a, fidx)
                normal_vel = is_vel and c == a
                if pb == INLET:
                    val = plane(sc, a, fidx - 1 if side == 0 else fidx)
                elif pb in (SLIP_WALL, NO_SLIP_WALL, SYMMETRY):
                    zero = (is_vel and pb == NO_SLIP_WALL) or normal_vel
                    val = 0.0 if zero else inner
                elif pb == OUTLET:
                    val = inner
                    if normal_vel:
                        val = (inner.clamp(max=0.0) if side == 0
                               else inner.clamp(min=0.0))
                else:
                    continue
                _put(edge, a, fidx, val.clone() if torch.is_tensor(val)
                     else val)
            e = _crop(edge, a, ng, n_cell)
            sedge[a].append(e)
            sflux[a].append(_crop(edge * macw[a], a, ng, n_cell) if cons
                            else torch.zeros_like(e))
    return (torch.stack(sedge[0]), torch.stack(sedge[1]),
            torch.stack(sflux[0]), torch.stack(sflux[1]))
