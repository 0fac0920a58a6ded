"""Debug-oracle Godunov implementations, full-array roll form (counterpart
of varden_tpu.ops.godunov_ref).

The round-1 formulation, kept as the oracle of the windowed path and the
kernels: the role the reference's *_debug_* variants play
(src/velpred.f90:526-1774, src/mkflux.f90:693-1184,2569-3882, selected by
use_godunov_debug, _parameters:83): the same math with the simplest
indexing. Every intermediate is a full ghost-padded tensor, a shift is a
periodic roll (slopes.shift), and a boundary face is overwritten by a
masked select (_face_set) that builds a new tensor. Points near the padded
edge hold garbage that the final interior crop never reads (ng = 3 bounds
every interior face's dependency cone). Selected at run time by the
use_godunov_debug flag (advance.py); plain PyTorch, no kernel.

Every function takes ``umax``: the largest |velocity| of the whole level,
from which the Riemann tie epsilon is formed (a decomposed run passes it,
so that the epsilon is the level's and not the block's); without it the
function forms it from its own input, as varden_tpu's does. ``force`` and
``mac_rhs`` may be None, meaning zero.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..config import INLET, NO_SLIP_WALL, OUTLET, PERIODIC, SLIP_WALL, SYMMETRY
from .godunov import _eps_from, _riemann_normal, _riemann_transverse
from .slopes import shift, slope_ref as slope


def _face_set(arr, axis, idx, val):
    """A copy of arr with the face plane idx along axis set to val (a
    masked select over the whole tensor)."""
    shape = [1] * arr.ndim
    shape[axis] = arr.shape[axis]
    ii = torch.arange(arr.shape[axis], device=arr.device).reshape(shape)
    return torch.where(ii == idx, val, arr)


def _face_get(arr, axis, idx):
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(idx, idx + 1)
    return arr[tuple(sl)]


def _eps(umax, own):
    """The tie epsilon from the level's max |velocity|, else from own()."""
    return _eps_from(own() if umax is None else umax)


# ---------------------------------------------------------------------------
# velpred: MAC velocity prediction
# ---------------------------------------------------------------------------

def velpred_2d(u, force, dt, dx: Sequence[float], phys_bc, adv_bc_vel,
               ng: int, n_cell: Sequence[int], slope_order: int,
               use_minion: bool, umax=None) -> Tuple[torch.Tensor, ...]:
    """Predict face-centred MAC velocities. u, force: (2, Nx, Ny)
    ghost-padded. Returns interior (nx+1, ny) umac and (nx, ny+1) vmac."""
    nx, ny = n_cell
    dt2, dt4 = 0.5 * dt, 0.25 * dt
    hx, hy = dx
    eps = _eps(umax, lambda: u[:, ng:ng + nx, ng:ng + ny].abs().max())

    slx = [slope(u[c], 0, ng, adv_bc_vel[c][0][0], adv_bc_vel[c][0][1],
                 slope_order, nx) for c in range(2)]
    sly = [slope(u[c], 1, ng, adv_bc_vel[c][1][0], adv_bc_vel[c][1][1],
                 slope_order, ny) for c in range(2)]

    def normal_states(axis, sl_ax, h):
        """1-D extrapolation of both velocity components to ``axis`` faces
        (velpred.f90:258-273)."""
        un = u[axis]
        lo_fac = 0.5 - dt2 * un.clamp(min=0.0) / h
        hi_fac = 0.5 + dt2 * un.clamp(max=0.0) / h
        l = [shift(u[c] + lo_fac * sl_ax[c], axis, -1) for c in range(2)]
        r = [u[c] - hi_fac * sl_ax[c] for c in range(2)]
        if use_minion and force is not None:
            l = [l[c] + dt2 * shift(force[c], axis, -1) for c in range(2)]
            r = [r[c] + dt2 * force[c] for c in range(2)]
        return l, r

    def apply_face_bc(l, r, axis, n_ax):
        """Physical-boundary overrides on the normal-face states
        (velpred.f90:276-308)."""
        nrm, tng = axis, 1 - axis
        for side, fidx in ((0, ng), (1, ng + n_ax)):
            pb = phys_bc[axis][side]
            if pb == PERIODIC:
                continue
            gidx = fidx - 1 if side == 0 else fidx
            ug = [_face_get(u[c], axis, gidx) for c in range(2)]
            ln = _face_get(l[nrm], axis, fidx)
            rn = _face_get(r[nrm], axis, fidx)
            lt = _face_get(l[tng], axis, fidx)
            rt = _face_get(r[tng], axis, fidx)
            if pb == INLET:
                ln = rn = ug[nrm]
                lt = rt = ug[tng]
            elif pb == SLIP_WALL:
                ln = rn = torch.zeros_like(ln)
                if side == 0:
                    lt = rt
                else:
                    rt = lt
            elif pb == NO_SLIP_WALL:
                ln = rn = torch.zeros_like(ln)
                lt = rt = torch.zeros_like(lt)
            elif pb == OUTLET:
                if side == 0:
                    rn = rn.clamp(max=0.0)
                    ln = rn
                    lt = rt
                else:
                    ln = ln.clamp(min=0.0)
                    rn = ln
                    rt = lt
            elif pb == SYMMETRY:
                # reflect: normal odd -> face value 0; tangential even
                ln = rn = torch.zeros_like(ln)
            l[nrm] = _face_set(l[nrm], axis, fidx, ln)
            r[nrm] = _face_set(r[nrm], axis, fidx, rn)
            l[tng] = _face_set(l[tng], axis, fidx, lt)
            r[tng] = _face_set(r[tng], axis, fidx, rt)
        return l, r

    # intermediate (hat) states on x- and y-faces
    ulx, urx = apply_face_bc(*normal_states(0, slx, hx), 0, nx)
    uimhx0 = _riemann_normal(ulx[0], urx[0], eps)
    uimhx1 = _riemann_transverse(ulx[1], urx[1], uimhx0, eps)
    uly, ury = apply_face_bc(*normal_states(1, sly, hy), 1, ny)
    uimhy1 = _riemann_normal(uly[1], ury[1], eps)
    uimhy0 = _riemann_transverse(uly[0], ury[0], uimhy1, eps)

    def full_states(axis, l_ax, r_ax, t_imh_n, t_imh_t, h_t):
        """Add the transverse correction (velpred.f90:402-498)."""
        t = 1 - axis
        tn_lo, tn_hi = t_imh_n, shift(t_imh_n, t, 1)
        tt_lo, tt_hi = t_imh_t, shift(t_imh_t, t, 1)
        corr = (dt4 / h_t) * (tn_lo + tn_hi) * (tt_hi - tt_lo)
        macl = l_ax[axis] - shift(corr, axis, -1)
        macr = r_ax[axis] - corr
        if not use_minion and force is not None:
            macl = macl + dt2 * shift(force[axis], axis, -1)
            macr = macr + dt2 * force[axis]
        return macl, macr

    umacl, umacr = full_states(0, ulx, urx, uimhy1, uimhy0, hy)
    vmacl, vmacr = full_states(1, uly, ury, uimhx0, uimhx1, hx)

    def finalize(axis, macl, macr, n_ax):
        mac = _riemann_normal(macl, macr, eps)
        for side, fidx in ((0, ng), (1, ng + n_ax)):
            pb = phys_bc[axis][side]
            if pb == PERIODIC:
                continue
            cur = _face_get(mac, axis, fidx)
            if pb in (SLIP_WALL, NO_SLIP_WALL, SYMMETRY):
                val = torch.zeros_like(cur)
            elif pb == INLET:
                gidx = fidx - 1 if side == 0 else fidx
                val = _face_get(u[axis], axis, gidx)
            elif pb == OUTLET:
                if side == 0:
                    val = _face_get(macr, axis, fidx).clamp(max=0.0)
                else:
                    val = _face_get(macl, axis, fidx).clamp(min=0.0)
            else:
                continue
            mac = _face_set(mac, axis, fidx, val)
        return mac

    umac = finalize(0, umacl, umacr, nx)
    vmac = finalize(1, vmacl, vmacr, ny)
    return (umac[ng:ng + nx + 1, ng:ng + ny],
            vmac[ng:ng + nx, ng:ng + ny + 1])


# ---------------------------------------------------------------------------
# mkflux: edge states / fluxes for cell-centred quantities
# ---------------------------------------------------------------------------

def mkflux_2d(s, umac_pad, vmac_pad, force, mac_rhs, dt,
              dx: Sequence[float], phys_bc, adv_bc, ng: int,
              n_cell: Sequence[int], is_vel: bool,
              is_conservative: Sequence[bool], slope_order: int,
              use_minion: bool, umax=None):
    """Godunov edge states sedgex/sedgey and conservative fluxes.

    s, force: (nc, Nx, Ny) ghost-padded (mac_rhs (Nx, Ny)). umac_pad and
    vmac_pad: cell-aligned padded face tensors with valid tangential ghost
    rows. Returns interior sedgex (nc, nx+1, ny), sedgey (nc, nx, ny+1),
    fluxx, fluxy."""
    nx, ny = n_cell
    nc = s.shape[0]
    dt2, dt4 = 0.5 * dt, 0.25 * dt
    hx, hy = dx
    eps = _eps(umax, lambda: torch.maximum(
        umac_pad[ng:ng + nx + 1, ng:ng + ny].abs().max(),
        vmac_pad[ng:ng + nx, ng:ng + ny + 1].abs().max()))

    slopes = ([slope(s[c], 0, ng, adv_bc[c][0][0], adv_bc[c][0][1],
                     slope_order, nx) for c in range(nc)],
              [slope(s[c], 1, ng, adv_bc[c][1][0], adv_bc[c][1][1],
                     slope_order, ny) for c in range(nc)])
    mac = (umac_pad, vmac_pad)
    n_ax = (nx, ny)
    h = (hx, hy)

    def normal_states(c, axis):
        """1-D extrapolation of s[c] to ``axis`` faces (mkflux.f90:299-314)."""
        adv = mac[axis]
        sl_ax = slopes[axis][c]
        l = shift(s[c] + (0.5 * torch.ones_like(adv)) * sl_ax, axis, -1) \
            - (dt2 / h[axis]) * adv * shift(sl_ax, axis, -1)
        r = s[c] - (0.5 + dt2 * adv / h[axis]) * sl_ax
        if use_minion and force is not None:
            l = l + dt2 * shift(force[c], axis, -1)
            r = r + dt2 * force[c]
        if use_minion and is_conservative[c] and mac_rhs is not None:
            l = l - dt2 * shift(s[c] * mac_rhs, axis, -1)
            r = r - dt2 * s[c] * mac_rhs
        return l, r

    def apply_face_bc(l, r, c, axis):
        """mkflux.f90:318-376 boundary overrides on normal states."""
        for side, fidx in ((0, ng), (1, ng + n_ax[axis])):
            pb = phys_bc[axis][side]
            if pb == PERIODIC:
                continue
            gidx = fidx - 1 if side == 0 else fidx
            sg = _face_get(s[c], axis, gidx)
            lv = _face_get(l, axis, fidx)
            rv = _face_get(r, axis, fidx)
            normal_vel = is_vel and c == axis
            if pb == INLET:
                lv = rv = sg
            elif pb == SLIP_WALL:
                if normal_vel:
                    lv = rv = torch.zeros_like(lv)
                elif side == 0:
                    lv = rv
                else:
                    rv = lv
            elif pb == NO_SLIP_WALL:
                if is_vel:
                    lv = rv = torch.zeros_like(lv)
                elif side == 0:
                    lv = rv
                else:
                    rv = lv
            elif pb == OUTLET:
                if normal_vel:
                    if side == 0:
                        lv = rv = rv.clamp(max=0.0)
                    else:
                        lv = rv = lv.clamp(min=0.0)
                elif side == 0:
                    lv = rv
                else:
                    rv = lv
            elif pb == SYMMETRY:
                if normal_vel:
                    lv = rv = torch.zeros_like(lv)
                elif side == 0:
                    lv = rv
                else:
                    rv = lv
            l = _face_set(l, axis, fidx, lv)
            r = _face_set(r, axis, fidx, rv)
        return l, r

    out = ([], [], [], [])
    for c in range(nc):
        cons = is_conservative[c]
        # hat states on both face sets
        ls, rs, hats = [], [], []
        for axis in range(2):
            l, r = apply_face_bc(*normal_states(c, axis), c, axis)
            ls.append(l)
            rs.append(r)
            hats.append(_riemann_transverse(l, r, mac[axis], eps))

        def edge_states(axis):
            """Transverse-corrected edge states (mkflux.f90:470-505,
            573-601)."""
            t = 1 - axis
            h_t = h[t]
            a_lo, a_hi = mac[t], shift(mac[t], t, 1)
            h_lo, h_hi = hats[t], shift(hats[t], t, 1)
            if cons:
                corr = (dt2 / h_t) * (h_hi * a_hi - h_lo * a_lo) \
                    - (dt2 / h_t) * s[c] * (a_hi - a_lo)
            else:
                corr = (dt4 / h_t) * (a_lo + a_hi) * (h_hi - h_lo)
            el = ls[axis] - shift(corr, axis, -1)
            er = rs[axis] - corr
            if not use_minion and force is not None:
                el = el + dt2 * shift(force[c], axis, -1)
                er = er + dt2 * force[c]
            if not use_minion and cons and mac_rhs is not None:
                el = el - dt2 * shift(s[c] * mac_rhs, axis, -1)
                er = er - dt2 * s[c] * mac_rhs
            return el, er

        def finalize(axis, el, er):
            """Riemann + boundary overrides on final edge states
            (mkflux.f90:508-553, 604-651)."""
            edge = _riemann_transverse(el, er, mac[axis], eps)
            for side, fidx in ((0, ng), (1, ng + n_ax[axis])):
                pb = phys_bc[axis][side]
                if pb == PERIODIC:
                    continue
                gidx = fidx - 1 if side == 0 else fidx
                inner = _face_get(er if side == 0 else el, axis, fidx)
                normal_vel = is_vel and c == axis
                if pb == INLET:
                    val = _face_get(s[c], axis, gidx)
                elif pb in (SLIP_WALL, NO_SLIP_WALL, SYMMETRY):
                    if (is_vel and pb == NO_SLIP_WALL) or normal_vel:
                        val = torch.zeros_like(inner)
                    else:
                        val = inner
                elif pb == OUTLET:
                    if normal_vel:
                        val = (inner.clamp(max=0.0) if side == 0
                               else inner.clamp(min=0.0))
                    else:
                        val = inner
                else:
                    continue
                edge = _face_set(edge, axis, fidx, val)
            return edge

        for axis in range(2):
            edge = finalize(axis, *edge_states(axis))
            out[axis].append(edge)
            out[2 + axis].append(edge * mac[axis] if cons
                                 else torch.zeros_like(edge))

    def crop(f, axis):
        return f[ng:ng + nx + (axis == 0), ng:ng + ny + (axis == 1)]

    # crop before stacking: the stack then joins interior-sized tensors
    return tuple(torch.stack([crop(f, k % 2) for f in out[k]])
                 for k in range(4))


# ---------------------------------------------------------------------------
# 3-D
# ---------------------------------------------------------------------------

_OTHERS = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def _third(a, b):
    return 3 - a - b


def _crop3(f, a, ng, n_cell):
    return f[tuple(slice(ng, ng + n_cell[t] + (1 if t == a else 0))
                   for t in range(3))]


def vel_slopes_3d(u, adv_bc_vel, ng, n_cell, slope_order):
    """Per-axis limited slopes of all velocity components, [axis][comp]
    (shared between velpred and the velocity mkflux: the math is the
    same)."""
    return [[slope(u[c], a, ng, adv_bc_vel[c][a][0], adv_bc_vel[c][a][1],
                   slope_order, n_cell[a]) for c in range(3)]
            for a in range(3)]


def velpred_3d(u, force, dt, dx: Sequence[float], phys_bc, adv_bc_vel,
               ng: int, n_cell: Sequence[int], slope_order: int,
               use_minion: bool, slopes=None, umax=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """u, force: (3, Nx, Ny, Nz) ghost-padded. Returns interior MAC faces."""
    dm = 3
    dt2, dt4, dt6 = 0.5 * dt, 0.25 * dt, dt / 6.0
    eps = _eps(umax, lambda: u[:, ng:ng + n_cell[0], ng:ng + n_cell[1],
                               ng:ng + n_cell[2]].abs().max())
    if slopes is None:
        slopes = vel_slopes_3d(u, adv_bc_vel, ng, n_cell, slope_order)

    def apply_face_bc(l, r, axis):
        """velpred.f90:1074-1105-style overrides on hat states (all
        components)."""
        for side, fidx in ((0, ng), (1, ng + n_cell[axis])):
            pb = phys_bc[axis][side]
            if pb == PERIODIC:
                continue
            gidx = fidx - 1 if side == 0 else fidx
            for c in range(dm):
                lv = _face_get(l[c], axis, fidx)
                rv = _face_get(r[c], axis, fidx)
                if pb == INLET:
                    lv = rv = _face_get(u[c], axis, gidx)
                elif pb == SLIP_WALL:
                    if c == axis:
                        lv = rv = torch.zeros_like(lv)
                    elif side == 0:
                        lv = rv
                    else:
                        rv = lv
                elif pb == NO_SLIP_WALL:
                    lv = rv = torch.zeros_like(lv)
                elif pb == OUTLET:
                    if c == axis:
                        if side == 0:
                            lv = rv = rv.clamp(max=0.0)
                        else:
                            lv = rv = lv.clamp(min=0.0)
                    elif side == 0:
                        lv = rv
                    else:
                        rv = lv
                elif pb == SYMMETRY:
                    if c == axis:
                        lv = rv = torch.zeros_like(lv)
                l[c] = _face_set(l[c], axis, fidx, lv)
                r[c] = _face_set(r[c], axis, fidx, rv)
        return l, r

    # ---- stage 1: hat states on each face set
    uls, urs, uimh = [], [], []
    for a in range(dm):
        un = u[a]
        lo_fac = 0.5 - dt2 * un.clamp(min=0.0) / dx[a]
        hi_fac = 0.5 + dt2 * un.clamp(max=0.0) / dx[a]
        l = [shift(u[c] + lo_fac * slopes[a][c], a, -1) for c in range(dm)]
        r = [u[c] - hi_fac * slopes[a][c] for c in range(dm)]
        if use_minion and force is not None:
            l = [l[c] + dt2 * shift(force[c], a, -1) for c in range(dm)]
            r = [r[c] + dt2 * force[c] for c in range(dm)]
        l, r = apply_face_bc(l, r, a)
        normal = _riemann_normal(l[a], r[a], eps)
        uimh.append([normal if c == a
                     else _riemann_transverse(l[c], r[c], normal, eps)
                     for c in range(dm)])
        uls.append(l)
        urs.append(r)

    def dhat_bc(l, r, axis, comp):
        """Double-hat / full-state transverse BC (velpred.f90:1324-1341):
        INLET -> ghost value; SLIP_WALL/OUTLET -> copy inner; NO_SLIP -> 0."""
        for side, fidx in ((0, ng), (1, ng + n_cell[axis])):
            pb = phys_bc[axis][side]
            if pb == PERIODIC:
                continue
            gidx = fidx - 1 if side == 0 else fidx
            lv = _face_get(l, axis, fidx)
            rv = _face_get(r, axis, fidx)
            if pb == INLET:
                lv = rv = _face_get(u[comp], axis, gidx)
            elif pb in (SLIP_WALL, OUTLET, SYMMETRY):
                if side == 0:
                    lv = rv
                else:
                    rv = lv
            elif pb == NO_SLIP_WALL:
                lv = rv = torch.zeros_like(lv)
            l = _face_set(l, axis, fidx, lv)
            r = _face_set(r, axis, fidx, rv)
        return l, r

    # ---- stage 2: double-hat states dhat[(n, a)] = comp n on a-faces
    # corrected along b = third axis (velpred.f90:1306-1600)
    dhat = {}
    for n in range(dm):
        for a in _OTHERS[n]:
            b = _third(n, a)
            hb_b, hb_n = uimh[b][b], uimh[b][n]
            corr = (dt6 / dx[b]) * (hb_b + shift(hb_b, b, 1)) * \
                (shift(hb_n, b, 1) - hb_n)
            l = uls[a][n] - shift(corr, a, -1)
            r = urs[a][n] - corr
            l, r = dhat_bc(l, r, a, n)
            dhat[(n, a)] = _riemann_transverse(l, r, uimh[a][a], eps)

    # ---- stage 3: full MAC states (velpred.f90:1587-1774)
    macs = []
    for nrm in range(dm):
        corr = torch.zeros_like(u[0])
        for t in _OTHERS[nrm]:
            ht, dh = uimh[t][t], dhat[(nrm, t)]
            corr = corr + (dt4 / dx[t]) * (ht + shift(ht, t, 1)) * \
                (shift(dh, t, 1) - dh)
        macl = uls[nrm][nrm] - shift(corr, nrm, -1)
        macr = urs[nrm][nrm] - corr
        if not use_minion and force is not None:
            macl = macl + dt2 * shift(force[nrm], nrm, -1)
            macr = macr + dt2 * force[nrm]
        mac = _riemann_normal(macl, macr, eps)
        for side, fidx in ((0, ng), (1, ng + n_cell[nrm])):
            pb = phys_bc[nrm][side]
            if pb == PERIODIC:
                continue
            cur = _face_get(mac, nrm, fidx)
            if pb in (SLIP_WALL, NO_SLIP_WALL, SYMMETRY):
                val = torch.zeros_like(cur)
            elif pb == INLET:
                gidx = fidx - 1 if side == 0 else fidx
                val = _face_get(u[nrm], nrm, gidx)
            elif pb == OUTLET:
                if side == 0:
                    val = _face_get(macr, nrm, fidx).clamp(max=0.0)
                else:
                    val = _face_get(macl, nrm, fidx).clamp(min=0.0)
            else:
                continue
            mac = _face_set(mac, nrm, fidx, val)
        macs.append(mac)
    return tuple(_crop3(macs[a], a, ng, n_cell) for a in range(dm))


# ---------------------------------------------------------------------------
# mkflux 3-D
# ---------------------------------------------------------------------------

def mkflux_3d(s, mac_pads: Sequence[torch.Tensor], force, mac_rhs, dt,
              dx: Sequence[float], phys_bc, adv_bc, ng: int,
              n_cell: Sequence[int], is_vel: bool,
              is_conservative: Sequence[bool], slope_order: int,
              use_minion: bool, slopes=None, umax=None):
    """Edge states and fluxes on all three face sets.

    s, force: (nc, N...) padded; mac_rhs: (N...) padded; mac_pads:
    cell-aligned padded MAC faces with valid tangential ghosts. ``slopes``:
    the limited slopes [axis][comp] where the caller has them. Returns
    (sedge, sflux) tuples of (nc, faces) interior tensors per direction."""
    dm = 3
    nc = s.shape[0]
    dt2, dt3 = 0.5 * dt, dt / 3.0
    dt4, dt6 = 0.25 * dt, dt / 6.0
    eps = _eps(umax, lambda: torch.stack(
        [m.abs().max() for m in mac_pads]).max())
    if slopes is None:
        slopes = [[slope(s[c], a, ng, adv_bc[c][a][0], adv_bc[c][a][1],
                         slope_order, n_cell[a]) for c in range(nc)]
                  for a in range(dm)]

    def face_bc(l, r, axis, c, sc):
        """mkflux.f90 boundary overrides on l/r states at axis faces."""
        for side, fidx in ((0, ng), (1, ng + n_cell[axis])):
            pb = phys_bc[axis][side]
            if pb == PERIODIC:
                continue
            gidx = fidx - 1 if side == 0 else fidx
            sg = _face_get(sc, axis, gidx)
            lv = _face_get(l, axis, fidx)
            rv = _face_get(r, axis, fidx)
            normal_vel = is_vel and c == axis
            if pb == INLET:
                lv = rv = sg
            elif pb == SLIP_WALL or pb == SYMMETRY:
                if normal_vel:
                    lv = rv = torch.zeros_like(lv)
                elif side == 0:
                    lv = rv
                else:
                    rv = lv
            elif pb == NO_SLIP_WALL:
                if is_vel:
                    lv = rv = torch.zeros_like(lv)
                elif side == 0:
                    lv = rv
                else:
                    rv = lv
            elif pb == OUTLET:
                if normal_vel:
                    if side == 0:
                        lv = rv = rv.clamp(max=0.0)
                    else:
                        lv = rv = lv.clamp(min=0.0)
                elif side == 0:
                    lv = rv
                else:
                    rv = lv
            l = _face_set(l, axis, fidx, lv)
            r = _face_set(r, axis, fidx, rv)
        return l, r

    sedge = [[] for _ in range(dm)]
    sflux = [[] for _ in range(dm)]
    for c in range(nc):
        sc = s[c]
        fc = None if force is None else force[c]
        cons = is_conservative[c]
        rhs = cons and mac_rhs is not None

        # stage 1: hat states
        sls, srs, simh = [], [], []
        for a in range(dm):
            adv = mac_pads[a]
            sl_a = slopes[a][c]
            l = shift(sc + 0.5 * sl_a, a, -1) - (dt2 / dx[a]) * adv * \
                shift(sl_a, a, -1)
            r = sc - (0.5 + dt2 * adv / dx[a]) * sl_a
            if use_minion and fc is not None:
                l = l + dt2 * shift(fc, a, -1)
                r = r + dt2 * fc
            if use_minion and rhs:
                l = l - dt2 * shift(sc * mac_rhs, a, -1)
                r = r - dt2 * sc * mac_rhs
            l, r = face_bc(l, r, a, c, sc)
            sls.append(l)
            srs.append(r)
            simh.append(_riemann_transverse(l, r, adv, eps))

        # stage 2: double-hat states dh[(a, b)] = s on a-faces corrected
        # along b
        dh = {}
        for a in range(dm):
            for b in _OTHERS[a]:
                mb, hb = mac_pads[b], simh[b]
                if cons:
                    fl = hb * mb
                    corr = (dt3 / dx[b]) * (shift(fl, b, 1) - fl)
                else:
                    corr = (dt6 / dx[b]) * (mb + shift(mb, b, 1)) * \
                        (shift(hb, b, 1) - hb)
                l = sls[a] - shift(corr, a, -1)
                r = srs[a] - corr
                l, r = face_bc(l, r, a, c, sc)
                dh[(a, b)] = _riemann_transverse(l, r, mac_pads[a], eps)

        # stage 3: final edge states with both transverse corrections
        for a in range(dm):
            corr = torch.zeros_like(sc)
            for t in _OTHERS[a]:
                b = _third(a, t)
                mt, dht = mac_pads[t], dh[(t, b)]
                if cons:
                    fl = dht * mt
                    corr = corr + (dt2 / dx[t]) * (shift(fl, t, 1) - fl) \
                        - (dt2 / dx[t]) * sc * (shift(mt, t, 1) - mt)
                else:
                    corr = corr + (dt4 / dx[t]) * (mt + shift(mt, t, 1)) * \
                        (shift(dht, t, 1) - dht)
            el = sls[a] - shift(corr, a, -1)
            er = srs[a] - corr
            if not use_minion and fc is not None:
                el = el + dt2 * shift(fc, a, -1)
                er = er + dt2 * fc
            if not use_minion and rhs:
                el = el - dt2 * shift(sc * mac_rhs, a, -1)
                er = er - dt2 * sc * mac_rhs
            edge = _riemann_transverse(el, er, mac_pads[a], eps)
            # final boundary overrides (pick inner state / clamp / zero)
            for side, fidx in ((0, ng), (1, ng + n_cell[a])):
                pb = phys_bc[a][side]
                if pb == PERIODIC:
                    continue
                gidx = fidx - 1 if side == 0 else fidx
                inner = _face_get(er if side == 0 else el, a, fidx)
                normal_vel = is_vel and c == a
                if pb == INLET:
                    val = _face_get(sc, a, gidx)
                elif pb in (SLIP_WALL, NO_SLIP_WALL, SYMMETRY):
                    if (is_vel and pb == NO_SLIP_WALL) or normal_vel:
                        val = torch.zeros_like(inner)
                    else:
                        val = inner
                elif pb == OUTLET:
                    if normal_vel:
                        val = (inner.clamp(max=0.0) if side == 0
                               else inner.clamp(min=0.0))
                    else:
                        val = inner
                else:
                    continue
                edge = _face_set(edge, a, fidx, val)
            sedge[a].append(_crop3(edge, a, ng, n_cell))
            sflux[a].append(_crop3(edge * mac_pads[a] if cons
                                   else torch.zeros_like(edge), a, ng,
                                   n_cell))

    return (tuple(torch.stack(f) for f in sedge),
            tuple(torch.stack(f) for f in sflux))
