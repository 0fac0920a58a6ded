"""Boundary-condition engine (counterpart of varden_tpu.bc).

  * physical BC codes   -> reference src/initialize.f90:385-411 (inputs integers)
  * adv_bc ghost tables -> reference src/define_bc_tower.f90:158-252
  * ell_bc solver codes -> reference src/define_bc_tower.f90:254-340
  * ghost-cell recipes  -> reference src/multifab_physbc.f90:64-300

Ghost cells are derived: ``fill_ghost`` takes an interior-only tensor and
returns a new padded tensor with every ghost value computed (periodic wrap +
physbc recipes). Spatial axes are the LAST ``dm`` axes; leading axes (a
component axis) broadcast.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .config import (INLET, INTERIOR, NO_SLIP_WALL, OUTLET, PERIODIC,
                     SLIP_WALL, SYMMETRY, VardenConfig)

# adv_bc ghost-fill recipe codes (FBoxLib bc_module semantics)
ADV_INTERIOR = 0   # no physical fill (periodic handled by wrap)
EXT_DIR = 1        # set ghost cells to a supplied boundary value
FOEXTRAP = 2       # first-order (copy) extrapolation
HOEXTRAP = 3       # (15 s1 - 10 s2 + 3 s3)/8 extrapolation
REFLECT_EVEN = 4
REFLECT_ODD = 5

# ell_bc elliptic-solver codes
BC_PER = 0
BC_NEU = 1
BC_DIR = 2


def adv_bc_table(cfg: VardenConfig):
    """adv_bc[comp][dir][side] recipe codes.

    Component layout matches reference define_bc_tower.f90:186-200:
    0..dm-1 velocity, dm..dm+nscal-1 scalars (density first), then pressure,
    then generic extrap.
    """
    dm, nscal = cfg.dm, cfg.nscal
    ncomp = dm + nscal + 2
    press = dm + nscal
    table = [[[ADV_INTERIOR, ADV_INTERIOR] for _ in range(dm)] for _ in range(ncomp)]
    for d in range(dm):
        for side in range(2):
            pb = cfg.phys_bc[d][side]
            if pb in (PERIODIC, INTERIOR):
                continue
            for comp in range(ncomp):
                if pb == SLIP_WALL:
                    if comp < dm:
                        code = EXT_DIR if comp == d else HOEXTRAP
                    elif comp < dm + nscal:
                        code = HOEXTRAP
                    else:
                        code = FOEXTRAP
                elif pb == NO_SLIP_WALL:
                    if comp < dm:
                        code = EXT_DIR
                    elif comp < dm + nscal:
                        code = HOEXTRAP
                    else:
                        code = FOEXTRAP
                elif pb == INLET:
                    code = EXT_DIR if comp < dm + nscal else FOEXTRAP
                elif pb == OUTLET:
                    code = EXT_DIR if comp == press else FOEXTRAP
                elif pb == SYMMETRY:
                    if comp < dm:
                        code = REFLECT_ODD if comp == d else REFLECT_EVEN
                    elif comp < dm + nscal:
                        code = REFLECT_EVEN
                    elif comp == press:
                        code = EXT_DIR
                    else:
                        code = REFLECT_EVEN
                else:
                    raise ValueError(f"unknown phys_bc {pb}")
                table[comp][d][side] = code
    return table


def ell_bc_table(cfg: VardenConfig):
    """ell_bc[comp][dir][side]: 0..dm-1 vel, dm..dm+nscal-1 scalars, then
    pressure (reference define_bc_tower.f90:254-340)."""
    dm, nscal = cfg.dm, cfg.nscal
    ncomp = dm + nscal + 1
    press = dm + nscal
    table = [[[BC_PER, BC_PER] for _ in range(dm)] for _ in range(ncomp)]
    for d in range(dm):
        for side in range(2):
            pb = cfg.phys_bc[d][side]
            for comp in range(ncomp):
                if pb in (PERIODIC, INTERIOR):
                    code = BC_PER
                elif pb == SLIP_WALL:
                    code = BC_DIR if (comp == d and comp < dm) else BC_NEU
                elif pb == NO_SLIP_WALL:
                    code = BC_DIR if comp < dm else BC_NEU
                elif pb == INLET:
                    code = BC_DIR if comp < dm + nscal else BC_NEU
                elif pb == OUTLET:
                    code = BC_DIR if comp == press else BC_NEU
                elif pb == SYMMETRY:
                    code = BC_DIR if (comp == d and comp < dm) else BC_NEU
                else:
                    raise ValueError(f"unknown phys_bc {pb}")
                table[comp][d][side] = code
    return table


def bc_values(cfg: VardenConfig):
    """EXT_DIR boundary values per component/dir/side.

    Velocity comps use u_bc/v_bc/w_bc, density rho_bc, tracers trac_bc
    (reference multifab_physbc.f90:96-99); pressure and extrap use 0.
    """
    dm, nscal = cfg.dm, cfg.nscal
    src = [cfg.u_bc, cfg.v_bc, cfg.w_bc][:dm] + [cfg.rho_bc] + [cfg.trac_bc] * (nscal - 1)
    vals = [[[float(src[c][d][s]) for s in range(2)] for d in range(dm)]
            for c in range(dm + nscal)]
    vals += [[[0.0, 0.0] for _ in range(dm)] for _ in range(2)]  # pressure, extrap
    return vals


def _take(f, axis, i0, i1=None):
    sl = [slice(None)] * f.ndim
    sl[axis] = slice(i0, i1)
    return f[tuple(sl)]


def _lo_slab(f, axis, ng, code, val):
    """Ghost slab of width ng on the lo side of ``axis`` (reference
    multifab_physbc.f90 recipes)."""
    if code == EXT_DIR:
        shape = list(f.shape)
        shape[axis] = ng
        return torch.full(shape, val, dtype=f.dtype, device=f.device)
    if code == FOEXTRAP:
        return _take(f, axis, 0, 1).repeat_interleave(ng, dim=axis)
    if code == HOEXTRAP:
        g = (15.0 * _take(f, axis, 0, 1) - 10.0 * _take(f, axis, 1, 2)
             + 3.0 * _take(f, axis, 2, 3)) / 8.0
        return g.repeat_interleave(ng, dim=axis)
    if code in (REFLECT_EVEN, REFLECT_ODD):
        g = torch.flip(_take(f, axis, 0, ng), dims=(axis,))
        return -g if code == REFLECT_ODD else g
    raise ValueError(f"bad bc code {code}")


def _hi_slab(f, axis, ng, code, val):
    g = _lo_slab(torch.flip(f, dims=(axis,)), axis, ng, code, val)
    return torch.flip(g, dims=(axis,))


def _halo(f, dec, d, ng):
    """The ghost slabs of a decomposed block's internal faces along axis d
    (None on the others, and without a decomposition)."""
    if dec is None:
        return None, None
    from .parallel import halo
    return halo.exchange(f, dec, d, ng, ng)


def fill_ghost(f: torch.Tensor, ng: int, bc: Sequence[Sequence[int]],
               vals: Sequence[Sequence[float]] = None,
               pmask: Sequence[bool] = None, dm: int = None,
               dec=None) -> torch.Tensor:
    """Pad a cell-centered interior tensor with ``ng`` ghost cells per
    spatial axis and fill them (periodic wrap + physbc recipes).

    bc[d][side] are adv recipe codes; vals[d][side] the EXT_DIR values.
    Axes are processed in x,y,z order so later axes overwrite corner regions
    (multifab_physbc.f90:77-90 + pass ordering). With ``dec`` (a rank's
    block, parallel.mesh.Decomp) each internal face's ghosts come from the
    neighbour's block, grown along the earlier axes: the result is the
    whole level's fill sliced to the block.
    """
    dm = dm if dm is not None else len(bc)
    if vals is None:
        vals = [[0.0, 0.0] for _ in range(dm)]
    if pmask is None:
        pmask = [bc[d][0] == ADV_INTERIOR and bc[d][1] == ADV_INTERIOR
                 for d in range(dm)]
    for d in range(dm):
        axis = f.ndim - dm + d
        lo, hi = _halo(f, dec, d, ng)
        if pmask[d]:
            lo, hi = _take(f, axis, -ng), _take(f, axis, 0, ng)
        if lo is None:
            lo = _lo_slab(f, axis, ng, bc[d][0], vals[d][0])
        if hi is None:
            hi = _hi_slab(f, axis, ng, bc[d][1], vals[d][1])
        f = torch.cat([lo, f, hi], dim=axis)
    return f


def grow_mac(umac: Tuple[torch.Tensor, ...], ng: int,
             pmask: Sequence[bool], dec=None) -> Tuple[torch.Tensor, ...]:
    """Add ``ng`` tangential ghost faces to each MAC (face-centered)
    component: periodic wrap where periodic, copy-extrapolation elsewhere
    (macproject.f90:115-120, velpred.f90:102-119); from the neighbour on a
    decomposed block's internal faces (``dec``, as in fill_ghost)."""
    dm = len(umac)
    out = []
    for d, f in enumerate(umac):
        for t in range(dm):
            if t == d:
                continue  # normal direction carries no ghosts
            axis = f.ndim - dm + t
            lo, hi = _halo(f, dec, t, ng)
            if pmask[t]:
                lo, hi = _take(f, axis, -ng), _take(f, axis, 0, ng)
            if lo is None:
                lo = _lo_slab(f, axis, ng, FOEXTRAP, 0.0)
            if hi is None:
                hi = _hi_slab(f, axis, ng, FOEXTRAP, 0.0)
            f = torch.cat([lo, f, hi], dim=axis)
        out.append(f)
    return tuple(out)
