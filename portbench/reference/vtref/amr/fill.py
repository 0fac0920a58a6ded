"""Multi-level ghost filling (counterpart of varden_tpu.amr.fill):
fillpatch / multifab_fill_ghost_cells.

The reference's pre-step ghost machinery (varden.f90:273-300): every level's
padded tensor is derived from interior data, coarse-fine ghosts by
limited-slope interpolation from the parent level (lin_cc_interp),
physical-boundary ghosts by the physbc recipes, and a periodic wrap where a
level spans a periodic axis.

Under a mesh (``sim.ml_ranks`` > 1) every patch of every level is
decomposed over the same ranks (``MLGeom.decs``, one parallel.mesh.Decomp
a node): a rank holds its block of each patch, a block's ghosts on the
patch's inside come from the neighbour blocks (parallel.halo.exchange),
and the coarse-fine ghosts from the parent's padded blocks by
parallel.halo.fetch of the window the interpolation reads.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Sequence

import numpy as np
import torch

from .. import bc as bc_mod
from ..config import INTERIOR, PERIODIC
from ..parallel import halo
from ..parallel import mesh as pmesh
from ..solvers.mg import BC_GHOST
from ..solvers.mg import _coarsen_plan as mg_plan
from ..solvers.nodal import BOTTOM_SIZE as NODAL_BOTTOM
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
        ranks = getattr(sim, "ml_ranks", 0)
        self.decs = [None] * self.nlev
        if ranks > 1:
            mb = max(pmesh.MIN_BLOCK, sim.ng)
            self.decs = [_solver_decomp(pmesh.make_patch_decomp(
                s.n, s.lo, self.pmask_level(i), ranks, pmesh.rank(), mb,
                name=f"patch {i}"), self.dx(i), i)
                for i, s in enumerate(self.specs)]

    def sdec(self, node):
        """The Decomp the node's solver hierarchies run on: None where the
        patch is not cut (every rank solves it whole)."""
        dec = self.decs[node]
        if dec is None or not any(dec.split(d) for d in range(self.dm)):
            return None
        return dec

    # -- a rank's block of a node (the node itself when not decomposed) --
    def bn(self, node):
        """The block's cells per axis."""
        dec = self.decs[node]
        return self.specs[node].n if dec is None else dec.n

    def blo(self, node):
        """The block's first cell in its level's index space."""
        dec = self.decs[node]
        return self.specs[node].lo if dec is None else dec.glo

    def bkind(self, node, d, side):
        """side_kind of the block: 'int' where a neighbour block lies."""
        dec = self.decs[node]
        if dec is not None and dec.internal(d, side):
            return "int"
        return self.side_kind(node, d, side)

    def bpmask(self, node):
        """The periodic axes that the block wraps by itself."""
        dec = self.decs[node]
        pm = self.pmask_level(node)
        return pm if dec is None else list(dec.local_pmask)

    def adv_bc_block(self, node, comps):
        """The adv_bc tables of ``comps`` for the block: ADV_INTERIOR on
        its internal faces (its ghosts there are the neighbours' cells),
        as a decomposed Sim has them."""
        dec = self.decs[node]
        tabs = [self.sim.adv_bc[c] for c in comps]
        if dec is None:
            return tabs
        return [[[bc_mod.ADV_INTERIOR if dec.internal(d, s) else t[d][s]
                  for s in range(2)] for d in range(self.dm)] for t in tabs]

    def phys_bc_block(self, node):
        """phys_bc_level with PERIODIC (no physical boundary) on the
        block's internal faces, as a decomposed Sim has them."""
        out = self.phys_bc_level(node)
        dec = self.decs[node]
        if dec is None:
            return out
        return tuple(tuple(PERIODIC if dec.internal(d, s) else out[d][s]
                           for s in range(2)) for d in range(self.dm))

    def bnode_shape(self, node):
        """The block's node tensor shape: its closure along a split axis,
        the patch's nodes along the others."""
        dec = self.decs[node]
        pm = self.pmask_level(node)
        return tuple(b + 1 if dec is not None and dec.split(d)
                     else n + (0 if pm[d] else 1)
                     for d, (b, n) in enumerate(zip(self.bn(node),
                                                    self.specs[node].n)))

    # -- whole patches from blocks and back (I/O, regrid tags) ----------
    def gather(self, node, t, nodal_=False):
        """The whole patch on every rank from each rank's block (exact)."""
        dec = self.decs[node]
        if dec is None:
            return t
        if not nodal_:
            return halo.gather(t, dec)
        return halo.gather(t, dec, [0 if p else 1 for p in self.bpmask(node)],
                           [0 if p else 1 for p in dec.pmask])

    def block(self, node, t, nodal_=False):
        """The rank's block of a whole-patch tensor."""
        dec = self.decs[node]
        return t if dec is None else dec.block(t, nodal_).contiguous()

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
        if self.sim.cfg.pmask[d]:
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


def _solver_decomp(dec, dx, node):
    """``dec``, or the patch whole on every rank where the blocks are too
    small for the decomposed solvers: their finest level must coarsen on
    the blocks (mg._coarsen_plan, and halving every axis of more than
    nodal.BOTTOM_SIZE cells)."""
    dm = dec.dm
    if node == 0 or not any(dec.split(d) for d in range(dm)):
        return dec
    fac = mg_plan(dec.n_glob, dx, dm)
    ok = (fac is not None and dec.coarsen(fac) is not None
          and all(s % 2 == 0 and s > NODAL_BOTTOM for s in dec.n_glob)
          and dec.coarsen((2,) * dm) is not None)
    if ok:
        return dec
    warnings.warn(f"patch {node} (extent {dec.n_glob}) is too small to cut "
                  "for its solvers: every rank holds it whole")
    return dataclasses.replace(dec, rep=tuple(m > 1 for m in dec.mesh))


def fill_sides(geom: MLGeom, lev, fpad, ng, slab):
    """Overwrite the ghost slabs of a padded block (in place) axis by axis,
    x, y, z in order so that later axes own the corners: from the
    neighbour block on an internal face, ``slab(fint, axis, side, kind)``
    on a physical or self-periodic side (None: leave it), nothing on a
    coarse-fine side. Both slabs of an axis read the interior before
    either is written."""
    dm = geom.dm
    dec = geom.decs[lev]
    for d in range(dm):
        axis = fpad.ndim - dm + d
        fint = fpad[_sl(fpad.ndim, axis, slice(ng, -ng))]
        got = (None, None) if dec is None else \
            halo.exchange(fint, dec, d, ng, ng)
        slabs = []
        for side in range(2):
            kind = geom.bkind(lev, d, side)
            if kind == "int":
                slabs.append((side, got[side]))
            elif kind != "cf":
                sl_ = slab(fint, axis, side, kind)
                if sl_ is not None:
                    slabs.append((side, sl_))
        for side, sl_ in slabs:
            dst = slice(0, ng) if side == 0 else slice(-ng, None)
            fpad[_sl(fpad.ndim, axis, dst)] = sl_
    return fpad


def coarse_window(geom: MLGeom, lev, r, ng):
    """The parent-patch window (lo, hi) that the interpolation of rank r's
    block of ``lev`` grown by ``ng`` reads, with one cell of slope halo
    beyond (the slope of its outermost cells is dropped)."""
    dec = geom.decs[lev]
    spec, pspec = geom.specs[lev], geom.specs[geom.parent[lev]]
    blo = spec.lo if dec is None else dec.of_rank(r).glo
    n = geom.bn(lev)
    return (tuple((blo[d] - ng) // 2 - 1 - pspec.lo[d]
                  for d in range(geom.dm)),
            tuple(-((-(blo[d] + n[d] + ng)) // 2) + 1 - pspec.lo[d]
                  for d in range(geom.dm)))


def interp_window(geom: MLGeom, lev, ppad, ngp, ng, limit=True):
    """Rank's block of ``lev`` grown by ``ng``, interpolated from the
    parent's blocks padded by ``ngp`` (``ppad``): the window is fetched
    from the ranks that hold it, prolonged and cut to the grown block."""
    dm = geom.dm
    par = geom.parent[lev]
    win = halo.fetch(ppad, geom.decs[par],
                     lambda r: coarse_window(geom, lev, r, ng), pad=ngp)
    up = prolong_cells(win, dm, limit=limit)  # fine space, origin 2*c0
    del win
    c0 = coarse_window(geom, lev, pmesh.rank(), ng)[0]
    pspec = geom.specs[par]
    blo, n = geom.blo(lev), geom.bn(lev)
    sl = [slice(None)] * (up.ndim - dm)
    for d in range(dm):
        start = (blo[d] - ng) - 2 * (c0[d] + pspec.lo[d])
        sl.append(slice(start, start + n[d] + 2 * ng))
    return up[tuple(sl)].clone()


def child_image(geom: MLGeom, c, r, extra=None):
    """Rank r's block of child node ``c`` coarsened onto its parent: the
    box (lo, hi) in the parent patch's index (cells, or with ``extra[d]``
    = 1 faces along d)."""
    dec = geom.decs[c]
    glo = geom.specs[c].lo if dec is None else dec.of_rank(r).glo
    plo = geom.specs[geom.parent[c]].lo
    n = geom.bn(c)
    extra = extra or (0,) * geom.dm
    lo = tuple(g // 2 - p for g, p in zip(glo, plo))
    return lo, tuple(l + b // 2 + e for l, b, e in zip(lo, n, extra))


def put_into_parent(geom: MLGeom, c, parent_t, data, extra=None):
    """Write ``data``, the rank's block of child ``c`` restricted (see
    child_image), into the parent's blocks (in place); returns
    ``parent_t``. Replicated copies write the same values."""
    kind = "cell" if not extra or not any(extra) else list(extra).index(1)
    return halo.put(parent_t, geom.decs[geom.parent[c]],
                    lambda r: child_image(geom, c, r, extra), data,
                    kind=kind)


def level_max(geom: MLGeom, x):
    """max over the ranks of a 0-d tensor where the hierarchy is
    decomposed (exact)."""
    return x if geom.decs[0] is None else halo.all_max(x)


def level_min(geom: MLGeom, x):
    return x if geom.decs[0] is None else halo.all_min(x)


def pad_ml(geom: MLGeom, arrs: List[torch.Tensor], comp: int, lev: int,
           ng: int) -> torch.Tensor:
    """Ghost-padded tensor of one variable at one level (the rank's block
    of it under a mesh).

    arrs[l]: interior tensor at level l (leading axes broadcast). The
    recursion pads the parent with ng//2+2 ghosts so that the interpolation
    slab (with its slope halo) is always in range under proper nesting."""
    sim = geom.sim
    dm = geom.dm
    adv = sim.adv_bc[comp]
    vals = sim.bvals[comp] if comp < len(sim.bvals) else [[0.0, 0.0]] * dm

    if lev == 0:
        return bc_mod.fill_ghost(arrs[0], ng, adv, vals, geom.bpmask(0), dm,
                                 dec=geom.decs[0])

    ngp = ng // 2 + 2
    ppad = pad_ml(geom, arrs, comp, geom.parent[lev], ngp)
    fpad = interp_window(geom, lev, ppad, ngp, ng)
    del ppad
    # the interior is the fine data itself
    fpad[tuple([slice(None)] * (fpad.ndim - dm) + [slice(ng, -ng)] * dm)] = \
        arrs[lev]

    def slab(fint, axis, side, kind):
        if kind == "per":
            src = slice(-ng, None) if side == 0 else slice(0, ng)
            return fint[_sl(fint.ndim, axis, src)]
        code = adv[axis - (fint.ndim - dm)][side]
        if code == bc_mod.ADV_INTERIOR:
            return None
        slab_fn = bc_mod._lo_slab if side == 0 else bc_mod._hi_slab
        return slab_fn(fint, axis, ng, code,
                       vals[axis - (fint.ndim - dm)][side])

    return fill_sides(geom, lev, fpad, ng, slab)


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
