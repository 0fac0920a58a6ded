"""Multi-level ghost filling (counterpart of varden_tpu.amr.fill):
fillpatch / multifab_fill_ghost_cells.

The reference's pre-step ghost machinery (varden.f90:273-300): every level's
padded tensor is derived from interior data, coarse-fine ghosts by
limited-slope interpolation from the parent level (lin_cc_interp),
physical-boundary ghosts by the physbc recipes, and a periodic wrap where a
level spans a periodic axis.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import bc as bc_mod
from ..config import INTERIOR, PERIODIC
from ..solvers.mg import BC_GHOST
from ..state import Sim, State
from .hierarchy import LevelSpec, _sl, prolong_cells


class MLGeom:
    """Static multilevel geometry: a PATCH TREE of dense rectangles.

    Nodes are LevelSpec patches sorted by refinement depth; node 0 is the
    root (whole domain, depth 0) and every other node has a ``parent`` it
    is properly nested in. A level chain is the special case parent = [-1,
    0, 1, ...] (one patch per level), the default when no parent list is
    given. Patches at the same depth are isolated (the clustering merges
    boxes closer than the ghost width): they interact only through their
    common parent.

    ``nlev`` is the NODE count; ``ndepth`` the number of refinement levels.
    """

    def __init__(self, sim: Sim, specs: List[LevelSpec], parent=None,
                 depth=None):
        self.sim = sim
        self.specs = list(specs)
        self.nlev = len(specs)
        self.dm = sim.dm
        if parent is None:
            parent = [i - 1 for i in range(len(specs))]
            depth = list(range(len(specs)))
        self.parent = list(parent)
        self.depth = list(depth)
        if len(self.parent) != len(specs) or len(self.depth) != len(specs):
            raise ValueError("parent and depth need one entry per patch")
        if any(self.depth[self.parent[i]] != self.depth[i] - 1
               for i in range(1, len(specs))):
            raise ValueError("a patch's parent must be one level coarser")
        if any(self.depth[i] > self.depth[i + 1]
               for i in range(len(specs) - 1)):
            raise ValueError("patches must be sorted by depth")
        self.children = [[] for _ in specs]
        for i in range(1, len(specs)):
            self.children[self.parent[i]].append(i)
        self.ndepth = (max(self.depth) + 1) if specs else 0

    def nodes_at(self, d):
        return [i for i in range(self.nlev) if self.depth[i] == d]

    def key(self):
        """Static identity of the hierarchy (regrid keep-or-rebuild)."""
        return tuple((s.lo, s.n, p, d) for s, p, d in
                     zip(self.specs, self.parent, self.depth))

    def cells(self) -> int:
        return sum(int(np.prod(s.n)) for s in self.specs)

    def dx(self, node):
        return tuple(h / 2 ** self.depth[node] for h in self.sim.dx)

    def domain_n(self, node):
        return tuple(s * 2 ** self.depth[node] for s in self.sim.n_cell)

    def side_kind(self, node, d, side):
        """'per' (wraps on itself), 'phys', or 'cf' (interp from parent)."""
        spec = self.specs[node]
        dn = self.domain_n(node)
        spans = spec.lo[d] == 0 and spec.hi[d] == dn[d]
        at_edge = (spec.lo[d] == 0) if side == 0 else (spec.hi[d] == dn[d])
        if self.sim.pmask[d]:
            return "per" if spans else "cf"
        return "phys" if at_edge else "cf"

    def pmask_level(self, node):
        return [self.side_kind(node, d, 0) == "per" for d in range(self.dm)]

    def phys_bc_level(self, lev):
        """phys_bc codes for the Godunov kernels: the domain code on
        physical sides, INTERIOR / PERIODIC elsewhere (ghosts there already
        hold coarse-interpolated data)."""
        out = []
        for d in range(self.dm):
            pair = []
            for side in range(2):
                kind = self.side_kind(lev, d, side)
                if kind == "per":
                    pair.append(PERIODIC)
                elif kind == "phys":
                    pair.append(self.sim.phys_bc[d][side])
                else:
                    pair.append(INTERIOR)
            out.append(tuple(pair))
        return tuple(out)

    def ell_bc_level(self, lev, comp):
        """Elliptic BC codes per side for solvers at this level: domain
        codes on physical / periodic sides, BC_GHOST at coarse-fine sides."""
        out = []
        for d in range(self.dm):
            pair = []
            for side in range(2):
                kind = self.side_kind(lev, d, side)
                if kind == "per":
                    pair.append(bc_mod.BC_PER)
                elif kind == "phys":
                    pair.append(self.sim.ell_bc[comp][d][side])
                else:
                    pair.append(BC_GHOST)
            out.append(tuple(pair))
        return out


def _apply_physbc_pad(geom: MLGeom, lev, fpad, ng, adv, vals):
    """Overwrite ghost slabs of an already-padded tensor (in place) on
    physical / self-periodic sides, x, y, z in order so that later axes own
    the corners."""
    dm = geom.dm
    for d in range(dm):
        axis = fpad.ndim - dm + d
        kinds = (geom.side_kind(lev, d, 0), geom.side_kind(lev, d, 1))
        if kinds == ("cf", "cf"):
            continue
        fint = fpad[_sl(fpad.ndim, axis, slice(ng, -ng))]
        slabs = []
        for side in range(2):
            kind = kinds[side]
            if kind == "cf":
                continue
            if kind == "per":
                src = slice(-ng, None) if side == 0 else slice(0, ng)
                slab = fint[_sl(fint.ndim, axis, src)]
            else:
                code = adv[d][side]
                if code == bc_mod.ADV_INTERIOR:
                    continue
                slab_fn = bc_mod._lo_slab if side == 0 else bc_mod._hi_slab
                slab = slab_fn(fint, axis, ng, code, vals[d][side])
            slabs.append((side, slab))
        # both slabs read the interior before either is written
        for side, slab in slabs:
            dst = slice(0, ng) if side == 0 else slice(-ng, None)
            fpad[_sl(fpad.ndim, axis, dst)] = slab
    return fpad


def pad_ml(geom: MLGeom, arrs: List[torch.Tensor], comp: int, lev: int,
           ng: int) -> torch.Tensor:
    """Ghost-padded tensor of one variable at one level.

    arrs[l]: interior tensor at level l (leading axes broadcast). The
    recursion pads the parent with ng//2+2 ghosts so that the interpolation
    slab (with its slope halo) is always in range under proper nesting."""
    sim = geom.sim
    dm = geom.dm
    adv = sim.adv_bc[comp]
    vals = sim.bvals[comp] if comp < len(sim.bvals) else [[0.0, 0.0]] * dm

    if lev == 0:
        return bc_mod.fill_ghost(arrs[0], ng, adv, vals, sim.pmask, dm)

    par = geom.parent[lev]
    ngp = ng // 2 + 2
    ppad = pad_ml(geom, arrs, comp, par, ngp)
    spec = geom.specs[lev]
    pspec = geom.specs[par]

    c0 = [(spec.lo[d] - ng) // 2 - 1 for d in range(dm)]
    c1 = [-((-(spec.hi[d] + ng)) // 2) + 1 for d in range(dm)]
    sl = [slice(None)] * (ppad.ndim - dm)
    for d in range(dm):
        origin = pspec.lo[d] - ngp
        sl.append(slice(c0[d] - origin, c1[d] - origin))
    up = prolong_cells(ppad[tuple(sl)], dm)  # fine space, origin 2*c0
    del ppad
    sl = [slice(None)] * (up.ndim - dm)
    for d in range(dm):
        start = (spec.lo[d] - ng) - 2 * c0[d]
        sl.append(slice(start, start + spec.n[d] + 2 * ng))
    fpad = up[tuple(sl)].clone()
    del up
    # the interior is the fine data itself
    fpad[tuple([slice(None)] * (fpad.ndim - dm) + [slice(ng, -ng)] * dm)] = \
        arrs[lev]
    return _apply_physbc_pad(geom, lev, fpad, ng, adv, vals)


def pad_ml_multi(geom: MLGeom, arrs_by_level, comps: Sequence[int], lev: int,
                 ng: int) -> torch.Tensor:
    """Stack of padded components: arrs_by_level[l] has a leading comp
    axis."""
    out = []
    for i, comp in enumerate(comps):
        arrs = [arrs_by_level[l][i] for l in range(len(arrs_by_level))]
        out.append(pad_ml(geom, arrs, comp, lev, ng))
    return torch.stack(out)


def hierarchy_from_numpy(sim: Sim, specs, parent, depth, arrays):
    """Carry a hierarchy across packages: ``specs`` as (lo, n) pairs (or
    objects with .lo and .n, e.g. varden_tpu's LevelSpecs), the parent and
    depth lists, and per patch a dict of numpy arrays (u, s, gp, p) onto
    ``sim``'s device and dtype. Returns (MLGeom, list of States)."""
    lvl = [LevelSpec(tuple(int(v) for v in getattr(s, "lo", None) or s[0]),
                     tuple(int(v) for v in getattr(s, "n", None) or s[1]))
           for s in specs]
    geom = MLGeom(sim, lvl, list(parent), list(depth))
    states = [State(**{k: sim.tensor(a[k]) for k in ("u", "s", "gp", "p")})
              for a in arrays]
    return geom, states
