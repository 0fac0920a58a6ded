"""Unsplit BCG Godunov edge-state prediction, 3-D with full corner coupling
(counterpart of varden_tpu.ops.godunov3d; reference velpred_3d,
src/velpred.f90:880-2767, and mkflux_3d, src/mkflux.f90:1186-3882).

This is the plain PyTorch form behind both Godunov kernels of
ops/cuda_godunov.py. Every intermediate is a full ghost-padded tensor; a
shift is a periodic roll (ops/slopes.shift), so points near the padded edge
hold garbage that the final interior crop never reads: with ng=3 the
dependency cone of every interior face stays inside the padded array.

Stage structure (velpred.f90:1995-2004 pseudo-code):
  1. hat states     — 1-D normal predictor + Riemann per face set
  2. double-hat     — one transverse correction (dt/6 convective, dt/3
                      conservative in mkflux)
  3. full states    — both transverse corrections (dt/4 convective, dt/2
                      conservative) + forces + Riemann + face overrides.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..config import INLET, NO_SLIP_WALL, OUTLET, PERIODIC, SLIP_WALL, SYMMETRY
from .godunov import (_crop, _eps_from, _put, _riemann_normal,
                      _riemann_transverse, mac_wins)
from .slopes import plane, shift, slope

_OTHERS = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def _third(a, b):
    return 3 - a - b


def vel_slopes_3d(u, adv_bc_vel, ng, n_cell, slope_order):
    """Per-axis limited slopes of all velocity components. [axis][comp]."""
    return [[slope(u[c], a, ng, adv_bc_vel[c][a][0], adv_bc_vel[c][a][1],
                   slope_order, n_cell[a]) for c in range(3)]
            for a in range(3)]


def velpred_3d(u: torch.Tensor, force: torch.Tensor, dt, dx: Sequence[float],
               phys_bc, adv_bc_vel, ng: int, n_cell: Sequence[int],
               slope_order: int, use_minion: bool, bc_sides=None, eps=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """u, force: (3, Nx, Ny, Nz) ghost-padded. Returns interior MAC faces.

    ``bc_sides`` restricts physical-boundary treatment to the given
    (axis, side) pairs (None = all); ``eps`` overrides the Riemann tie
    epsilon (default ABS_EPS * max|u| over the interior)."""
    dm = 3
    dt2, dt4, dt6 = 0.5 * dt, 0.25 * dt, dt / 6.0
    if eps is None:
        eps = _eps_from(u[:, ng:ng + n_cell[0], ng:ng + n_cell[1],
                          ng:ng + n_cell[2]].abs().max())
    uw = [u[c] for c in range(dm)]
    fw = [force[c] for c in range(dm)]
    slopes = vel_slopes_3d(u, adv_bc_vel, ng, n_cell, slope_order)

    def skip_bc(axis, side):
        return bc_sides is not None and (axis, side) not in bc_sides

    def apply_face_bc(l, r, axis):
        """velpred.f90:1074-1105-style overrides on hat states (all comps)."""
        for side, fidx in ((0, ng), (1, ng + n_cell[axis])):
            pb = phys_bc[axis][side]
            if pb == PERIODIC or skip_bc(axis, side):
                continue
            gidx = fidx - 1 if side == 0 else fidx
            for c in range(dm):
                lv = plane(l[c], axis, fidx).clone()
                rv = plane(r[c], axis, fidx).clone()
                if pb == INLET:
                    lv = rv = plane(uw[c], axis, gidx)
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
                _put(l[c], axis, fidx, lv)
                _put(r[c], axis, fidx, rv)
        return l, r

    # ---- stage 1: hat states on each face set
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
        l, r = apply_face_bc(l, r, a)
        normal = _riemann_normal(l[a], r[a], eps)
        hat = [None] * dm
        hat[a] = normal
        for c in range(dm):
            if c != a:
                hat[c] = _riemann_transverse(l[c], r[c], normal, eps)
        uls.append(l)
        urs.append(r)
        uimh.append(hat)

    def dhat_bc(l, r, axis, comp):
        """Double-hat / full-state transverse BC (velpred.f90:1324-1341):
        INLET -> ghost value; SLIP_WALL/OUTLET -> copy inner; NO_SLIP -> 0."""
        for side, fidx in ((0, ng), (1, ng + n_cell[axis])):
            pb = phys_bc[axis][side]
            if pb == PERIODIC or skip_bc(axis, side):
                continue
            gidx = fidx - 1 if side == 0 else fidx
            lv = plane(l, axis, fidx).clone()
            rv = plane(r, axis, fidx).clone()
            if pb == INLET:
                lv = rv = plane(uw[comp], axis, gidx)
            elif pb in (SLIP_WALL, OUTLET, SYMMETRY):
                if side == 0:
                    lv = rv
                else:
                    rv = lv
            elif pb == NO_SLIP_WALL:
                lv = rv = torch.zeros_like(lv)
            _put(l, axis, fidx, lv)
            _put(r, axis, fidx, rv)
        return l, r

    # ---- stage 2: double-hat states dhat[(n, a)] = comp n on a-faces
    # corrected along b = third axis (velpred.f90:1306-1600)
    dhat = {}
    for n in range(dm):
        for a in _OTHERS[n]:
            b = _third(n, a)
            hb_b = uimh[b][b]
            hb_n = uimh[b][n]
            corr = (dt6 / dx[b]) * (hb_b + shift(hb_b, b, 1)) * \
                (shift(hb_n, b, 1) - hb_n)
            l = uls[a][n] - shift(corr, a, -1)
            r = urs[a][n] - corr
            l, r = dhat_bc(l, r, a, n)
            dhat[(n, a)] = _riemann_transverse(l, r, uimh[a][a], eps)

    # ---- stage 3: full MAC states (velpred.f90:1587-1774)
    macs = []
    for nrm in range(dm):
        corr = None
        for t in _OTHERS[nrm]:
            ht = uimh[t][t]
            dh = dhat[(nrm, t)]
            term = (dt4 / dx[t]) * (ht + shift(ht, t, 1)) * \
                (shift(dh, t, 1) - dh)
            corr = term if corr is None else corr + term
        macl = uls[nrm][nrm] - shift(corr, nrm, -1)
        macr = urs[nrm][nrm] - corr
        if not use_minion:
            macl = macl + dt2 * shift(fw[nrm], nrm, -1)
            macr = macr + dt2 * fw[nrm]
        mac = _riemann_normal(macl, macr, eps)
        for side, fidx in ((0, ng), (1, ng + n_cell[nrm])):
            pb = phys_bc[nrm][side]
            if pb == PERIODIC or skip_bc(nrm, side):
                continue
            if pb in (SLIP_WALL, NO_SLIP_WALL, SYMMETRY):
                val = 0.0
            elif pb == INLET:
                gidx = fidx - 1 if side == 0 else fidx
                val = plane(uw[nrm], nrm, gidx)
            elif pb == OUTLET:
                if side == 0:
                    val = plane(macr, nrm, fidx).clamp(max=0.0)
                else:
                    val = plane(macl, nrm, fidx).clamp(min=0.0)
            else:
                continue
            _put(mac, nrm, fidx, val)
        macs.append(mac)
    return tuple(_crop(macs[a], a, ng, n_cell) for a in range(dm))


# ---------------------------------------------------------------------------
# mkflux 3-D
# ---------------------------------------------------------------------------

def mkflux_3d(s: torch.Tensor, mac_pads: Sequence[torch.Tensor],
              force, mac_rhs, dt, dx: Sequence[float], phys_bc, adv_bc,
              ng: int, n_cell: Sequence[int], is_vel: bool,
              is_conservative: Sequence[bool], slope_order: int,
              use_minion: bool, bc_sides=None, eps=None):
    """Edge states & fluxes on all three face sets.

    s/force: (nc, N...) padded; mac_rhs: (N...) padded; mac_pads:
    cell-aligned padded MAC faces with one valid tangential ghost. force and
    mac_rhs may be None (statically zero: their terms are skipped). Returns
    (sedge, sflux) tuples of (nc, faces) interior tensors per direction."""
    dm = 3
    nc = s.shape[0]
    dt2, dt3 = 0.5 * dt, dt / 3.0
    dt4, dt6 = 0.25 * dt, dt / 6.0
    macw = list(mac_pads)
    if eps is None:
        eps = _eps_from(torch.stack([m.abs().max()
                                     for m in mac_wins(mac_pads, ng, n_cell)]
                                    ).max())

    def skip_bc(axis, side):
        return bc_sides is not None and (axis, side) not in bc_sides

    mrw = mac_rhs
    slopes = [[slope(s[c], a, ng, adv_bc[c][a][0], adv_bc[c][a][1],
                     slope_order, n_cell[a]) for c in range(nc)]
              for a in range(dm)]

    sedge_lists = [[] for _ in range(dm)]
    sflux_lists = [[] for _ in range(dm)]

    def face_bc(l, r, axis, c, sc):
        """mkflux.f90 boundary overrides on l/r states at axis faces."""
        for side, fidx in ((0, ng), (1, ng + n_cell[axis])):
            pb = phys_bc[axis][side]
            if pb == PERIODIC or skip_bc(axis, side):
                continue
            gidx = fidx - 1 if side == 0 else fidx
            lv = plane(l, axis, fidx).clone()
            rv = plane(r, axis, fidx).clone()
            normal_vel = is_vel and c == axis
            if pb == INLET:
                lv = rv = plane(sc, axis, gidx)
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
            _put(l, axis, fidx, lv)
            _put(r, axis, fidx, rv)
        return l, r

    for c in range(nc):
        sc = s[c]
        fc = force[c] if force is not None else None
        cons = is_conservative[c]

        # stage 1: hat states
        sls, srs, simh = [], [], []
        for a in range(dm):
            adv = macw[a]
            sl_a = slopes[a][c]
            l = shift(sc + 0.5 * sl_a, a, -1) - (dt2 / dx[a]) * adv * \
                shift(sl_a, a, -1)
            r = sc - (0.5 + dt2 * adv / dx[a]) * sl_a
            if use_minion and fc is not None:
                l = l + dt2 * shift(fc, a, -1)
                r = r + dt2 * fc
            if use_minion and cons and mrw is not None:
                l = l - dt2 * shift(sc * mrw, a, -1)
                r = r - dt2 * sc * mrw
            l, r = face_bc(l, r, a, c, sc)
            sls.append(l)
            srs.append(r)
            simh.append(_riemann_transverse(l, r, adv, eps))

        # stage 2: double-hat states dh[(a, b)] = s on a-faces corrected by b
        dh = {}
        for a in range(dm):
            for b in _OTHERS[a]:
                mb = macw[b]
                hb = simh[b]
                if cons:
                    fl = hb * mb
                    corr = (dt3 / dx[b]) * (shift(fl, b, 1) - fl)
                else:
                    corr = (dt6 / dx[b]) * (mb + shift(mb, b, 1)) * \
                        (shift(hb, b, 1) - hb)
                l = sls[a] - shift(corr, a, -1)
                r = srs[a] - corr
                l, r = face_bc(l, r, a, c, sc)
                dh[(a, b)] = _riemann_transverse(l, r, macw[a], eps)

        # stage 3: final edge states with both transverse corrections
        for a in range(dm):
            corr = None
            for t in _OTHERS[a]:
                b = _third(a, t)
                mt = macw[t]
                dht = dh[(t, b)]
                if cons:
                    flux_div = (dt2 / dx[t]) * (shift(dht * mt, t, 1)
                                                - dht * mt)
                    compr = (dt2 / dx[t]) * sc * (shift(mt, t, 1) - mt)
                    corr = (flux_div - compr if corr is None
                            else (corr + flux_div) - compr)
                else:
                    term = (dt4 / dx[t]) * (mt + shift(mt, t, 1)) * \
                        (shift(dht, t, 1) - dht)
                    corr = term if corr is None else corr + term
            el = sls[a] - shift(corr, a, -1)
            er = srs[a] - corr
            if (not use_minion) and fc is not None:
                el = el + dt2 * shift(fc, a, -1)
                er = er + dt2 * fc
            if (not use_minion) and cons and mrw is not None:
                el = el - dt2 * shift(sc * mrw, a, -1)
                er = er - dt2 * sc * mrw
            edge = _riemann_transverse(el, er, macw[a], eps)
            # final boundary overrides (pick inner state / clamp / zero)
            for side, fidx in ((0, ng), (1, ng + n_cell[a])):
                pb = phys_bc[a][side]
                if pb == PERIODIC or skip_bc(a, side):
                    continue
                gidx = fidx - 1 if side == 0 else fidx
                inner = plane(er if side == 0 else el, a, fidx)
                normal_vel = is_vel and c == a
                if pb == INLET:
                    val = plane(sc, a, gidx)
                elif pb in (SLIP_WALL, NO_SLIP_WALL, SYMMETRY):
                    if (is_vel and pb == NO_SLIP_WALL) or normal_vel:
                        val = 0.0
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
                _put(edge, a, fidx, val.clone() if torch.is_tensor(val)
                     else val)
            sedge_lists[a].append(_crop(edge, a, ng, n_cell))
            sflux_lists[a].append(_crop(edge * macw[a], a, ng, n_cell)
                                  if cons else None)

    sedge = tuple(torch.stack(sedge_lists[a]) for a in range(dm))
    sflux = tuple(torch.stack(
        [f if f is not None else torch.zeros_like(sedge_lists[a][i])
         for i, f in enumerate(sflux_lists[a])]) for a in range(dm))
    return sedge, sflux
