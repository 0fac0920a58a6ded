"""AMR level descriptors and grid-transfer operators (counterpart of
varden_tpu.amr.hierarchy).

The FBoxLib surface the reference consumes (SURVEY.md §2b):
ml_cc_restriction / ml_edge_restriction, lin_cc_interp-style limited-slope
prolongation (fillpatch / multifab_fill_ghost_cells) and nodal prolongation
(ml_prolongation). Every level is one dense rectangular tensor over the
level's bounding box, described by a static LevelSpec; ref_ratio = 2
throughout (reference _parameters:25). Leading (component) axes broadcast.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from ..solvers.mg import _sl


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """Static geometry of one AMR patch, in the index space of its level.

    Level 0 covers the whole domain: lo = 0, n = n_cell. Finer patches are
    single (clustered, quantized) boxes."""
    lo: Tuple[int, ...]
    n: Tuple[int, ...]

    @property
    def hi(self):
        return tuple(l + s for l, s in zip(self.lo, self.n))

    @property
    def dm(self):
        return len(self.n)


def domain_spec(n_cell, level):
    return LevelSpec(lo=(0,) * len(n_cell),
                     n=tuple(s * 2 ** level for s in n_cell))


def covered_slice(fine_spec: LevelSpec, r: int = 2):
    """Slice of the parent-level tensor covered by the fine box (parent
    tensor assumed to span its own full LevelSpec)."""
    return tuple(slice(l // r, (l + s) // r)
                 for l, s in zip(fine_spec.lo, fine_spec.n))


def _pairs_avg(f, axis):
    """0.5 * (even + odd) entries along ``axis``."""
    return 0.5 * (f[_sl(f.ndim, axis, slice(0, None, 2))]
                  + f[_sl(f.ndim, axis, slice(1, None, 2))])


def restrict_cells(f: torch.Tensor, dm: int) -> torch.Tensor:
    """2^dm-cell average (ml_cc_restriction)."""
    for d in range(dm):
        f = _pairs_avg(f, f.ndim - dm + d)
    return f


def restrict_faces(f: torch.Tensor, d: int, dm: int) -> torch.Tensor:
    """Average fine faces onto coincident coarse faces (ml_edge_restriction):
    keep even planes along d, average 2-blocks tangentially."""
    out = f[_sl(f.ndim, f.ndim - dm + d, slice(0, None, 2))]
    for t in range(dm):
        if t != d:
            out = _pairs_avg(out, out.ndim - dm + t)
    return out


def _mc_slopes(c: torch.Tensor, axis: int, limit: bool = True) -> torch.Tensor:
    """Undivided central slopes (MC-limited by default); zero in the
    outermost cells."""
    cp = c[_sl(c.ndim, axis, slice(2, None))]
    cm = c[_sl(c.ndim, axis, slice(0, -2))]
    cc = c[_sl(c.ndim, axis, slice(1, -1))]
    cen = 0.5 * (cp - cm)
    if limit:
        dpls = 2.0 * (cp - cc)
        dmin = 2.0 * (cc - cm)
        lim = torch.minimum(dpls.abs(), dmin.abs())
        lim = torch.where(dpls * dmin > 0.0, lim, torch.zeros_like(lim))
        s = torch.sign(cen) * torch.minimum(lim, cen.abs())
    else:
        s = cen
    z = torch.zeros_like(c[_sl(c.ndim, axis, slice(0, 1))])
    return torch.cat([z, s, z], dim=axis)


def _interleave(a, b, axis):
    """[a0, b0, a1, b1, ...] along ``axis``."""
    st = torch.stack([a, b], dim=axis + 1)
    shape = list(a.shape)
    shape[axis] = 2 * a.shape[axis]
    return st.reshape(shape)


def prolong_cells(c: torch.Tensor, dm: int, order: int = 1,
                  limit: bool = True) -> torch.Tensor:
    """Linear prolongation to 2x resolution. limit=True gives lin_cc_interp
    semantics (limited slopes, for ghost fills of advected state);
    limit=False is the plain linear operator of the solvers' coarse-fine
    ghosts (a limiter would make the composite operator nonlinear). The
    outermost source cells interpolate piecewise-constant."""
    out = c
    for d in range(dm):
        axis = out.ndim - dm + d
        if order >= 1:
            s = _mc_slopes(out, axis, limit=limit)
        else:
            s = torch.zeros_like(out)
        out = _interleave(out - 0.25 * s, out + 0.25 * s, axis)
    return out


def prolong_nodes(c: torch.Tensor, dm: int) -> torch.Tensor:
    """Linear nodal prolongation (ml_nodal_prolongation): n+1 coarse nodes
    per axis -> 2n+1 fine nodes."""
    for d in range(dm):
        axis = c.ndim - dm + d
        mid = 0.5 * (c[_sl(c.ndim, axis, slice(1, None))]
                     + c[_sl(c.ndim, axis, slice(0, -1))])
        z = torch.zeros_like(c[_sl(c.ndim, axis, slice(0, 1))])
        out = _interleave(c, torch.cat([mid, z], dim=axis), axis)
        c = out[_sl(out.ndim, axis, slice(0, 2 * c.shape[axis] - 1))]
    return c


def interp_patch(coarse: torch.Tensor, coarse_lo: Sequence[int],
                 fine_lo: Sequence[int], fine_n: Sequence[int],
                 dm: int) -> torch.Tensor:
    """Interpolate a fine-index-space patch [fine_lo, fine_lo+fine_n) from a
    coarse tensor whose element 0 sits at coarse index ``coarse_lo``. The
    coarse slab must cover the patch's coarse range grown by 1 (slopes)."""
    up = prolong_cells(coarse, dm)
    sl = [slice(None)] * (up.ndim - dm)
    for d in range(dm):
        start = fine_lo[d] - 2 * coarse_lo[d]
        sl.append(slice(start, start + fine_n[d]))
    return up[tuple(sl)]
