"""Tagging, clustering and regridding (counterpart of varden_tpu.amr.regrid).

The reference's tag_boxes -> make_new_grids -> enforce_proper_nesting
pipeline (initialize.f90:152-342, regrid.f90:20-272): tagged cells cluster
into Berger-Rigoutsos boxes, buffer and quantize, merge into ISOLATED
patches and nest into the patch tree. Clustering runs on the host in numpy;
the tags are computed on the run's device and copied to the host once per
regrid. Under a mesh each rank tags its blocks, the tags are gathered, and
every rank clusters the same tree; the new patches' blocks are filled from
the old hierarchy's blocks by parallel.halo.fetch.
"""
from __future__ import annotations

import math
import re
from typing import List, Tuple

import numpy as np
import torch

from .. import problems
from ..parallel import halo
from ..parallel import mesh as pmesh
from ..parallel.mesh import mesh_shape
from ..state import Sim, State
from .fill import MLGeom, child_image
from .hierarchy import LevelSpec, domain_spec, prolong_cells

QUANT = 8          # box edges quantized to multiples of this (fine index)
NEST_BUFFER = 2    # coarse-cell proper-nesting margin (enforce_proper_nesting)
MERGE_GAP = 8      # fine cells: boxes closer than this merge (>= ghost width,
                   # so sibling patches never interact through a stencil)


def cluster_tagged(tags: np.ndarray, min_eff: float = 0.7,
                   blocking: int = 4, min_width: int = 4):
    """Berger-Rigoutsos-style clustering of a boolean tag array into a list
    of boxes [(lo, hi)) in the tag array's own index space (FBoxLib's
    cluster module; knobs cluster_min_eff / cluster_blocking_factor /
    cluster_minwidth, probin.template:192-194): recursively split the tag
    bounding box at signature holes, else at the strongest Laplacian
    inflection of the signature, until each box's tagged fraction reaches
    ``min_eff``; box edges are quantized to ``blocking``."""
    dm = tags.ndim

    def bbox(t):
        idx = np.argwhere(t)
        return idx.min(axis=0), idx.max(axis=0) + 1

    def quantize(lo, hi, shape):
        lo = (lo // blocking) * blocking
        hi = np.minimum(-((-hi) // blocking) * blocking, shape)
        return lo, hi

    def rec(lo, hi, depth):
        sub = tags[tuple(slice(lo[d], hi[d]) for d in range(dm))]
        if not sub.any():
            return []
        blo, bhi = bbox(sub)
        lo2, hi2 = lo + blo, lo + bhi
        sub = tags[tuple(slice(lo2[d], hi2[d]) for d in range(dm))]
        eff = sub.sum() / sub.size
        widths = hi2 - lo2
        if eff >= min_eff or depth > 12 or (widths <= min_width).all():
            return [(lo2, hi2)]
        best = None
        for d in range(dm):
            sig = sub.sum(axis=tuple(t for t in range(dm) if t != d))
            if widths[d] < 2 * min_width:
                continue
            # hole split: a zero plane strictly inside
            holes = np.nonzero(sig == 0)[0]
            holes = holes[(holes >= min_width) &
                          (holes <= widths[d] - min_width)]
            if holes.size:
                best = (2, d, int(holes[holes.size // 2]))
                break
            # inflection split: max |second difference| sign change
            if widths[d] >= 4:
                lap = sig[2:] - 2 * sig[1:-1] + sig[:-2]
                cand_best = None
                for i in range(len(lap) - 1):
                    if lap[i] * lap[i + 1] < 0:
                        strength = abs(int(lap[i]) - int(lap[i + 1]))
                        cut = i + 2
                        if (min_width <= cut <= widths[d] - min_width and
                                (cand_best is None or
                                 strength > cand_best[0])):
                            cand_best = (strength, cut)
                if cand_best is not None and (best is None or best[0] < 1):
                    best = (1, d, cand_best[1])
        if best is None:
            # fall back: bisect the longest axis
            d = int(np.argmax(widths))
            if widths[d] < 2 * min_width:
                return [(lo2, hi2)]
            best = (0, d, int(widths[d] // 2))
        _, d, cut = best
        mid = lo2.copy()
        mid[d] += cut
        hi_a = hi2.copy()
        hi_a[d] = mid[d]
        return rec(lo2, hi_a, depth + 1) + rec(mid, hi2, depth + 1)

    shape = np.array(tags.shape)
    out = [quantize(lo, hi, shape) for lo, hi in
           rec(np.zeros(dm, int), shape, 0)]
    # merge boxes that overlap after quantization
    merged = True
    while merged and len(out) > 1:
        merged = False
        for i in range(len(out)):
            for j in range(i + 1, len(out)):
                (l1, h1), (l2, h2) = out[i], out[j]
                if (np.minimum(h1, h2) > np.maximum(l1, l2)).all():
                    out[i] = (np.minimum(l1, l2), np.maximum(h1, h2))
                    out.pop(j)
                    merged = True
                    break
            if merged:
                break
    return [(tuple(int(v) for v in lo), tuple(int(v) for v in hi))
            for lo, hi in out]


def _merge_near(boxes, gap):
    """Merge fine-space boxes whose separation is < ``gap`` cells until
    stable; the survivors are isolated patches."""
    out = [(np.asarray(lo), np.asarray(hi)) for lo, hi in boxes]
    merged = True
    while merged and len(out) > 1:
        merged = False
        for i in range(len(out)):
            for j in range(i + 1, len(out)):
                (l1, h1), (l2, h2) = out[i], out[j]
                if (np.minimum(h1 + gap, h2 + gap)
                        > np.maximum(l1 - gap, l2 - gap)).all():
                    out[i] = (np.minimum(l1, l2), np.maximum(h1, h2))
                    out.pop(j)
                    merged = True
                    break
            if merged:
                break
    return out


def _child_boxes(sim: Sim, tags: np.ndarray, tag_spec: LevelSpec, buf: int):
    """Cluster one node's tags into candidate CHILD boxes in the fine index
    space: clustered boxes -> global coarse cells -> buffer -> fine space ->
    QUANT alignment (isolation is enforced by the caller over all of a
    depth's candidates)."""
    if not tags.any():
        return []
    boxes = cluster_tagged(tags, min_eff=sim.cfg.cluster_min_eff,
                           blocking=sim.cfg.cluster_blocking_factor,
                           min_width=sim.cfg.cluster_min_width)
    out = []
    for lo, hi in boxes:
        lo_c = np.asarray(lo) + np.asarray(tag_spec.lo) - buf
        hi_c = np.asarray(hi) + np.asarray(tag_spec.lo) + buf
        out.append(((2 * lo_c // QUANT) * QUANT,
                    -((-2 * hi_c) // QUANT) * QUANT))
    return out


def _mesh_quanta(sim: Sim):
    """Per-axis extent quanta of a mesh run (cfg.mesh > 0): lcm(2, ranks
    along the axis), so that a patch's extent divides the mesh axis, as
    varden_tpu's regridder snaps it (varden_tpu/amr/regrid.py:171-183).
    None off-mesh."""
    if sim.cfg.mesh <= 0:
        return None
    shape = mesh_shape(sim.cfg.mesh)
    return [math.lcm(2, shape[d]) if d < len(shape) else 1
            for d in range(sim.dm)]


def _nest_into(sim: Sim, lo_f, hi_f, parent: LevelSpec, parent_depth: int):
    """Clip a fine-space box to nest NEST_BUFFER coarse cells inside its
    parent patch (flush sides at the domain boundary are exempt); returns a
    LevelSpec, or None if the clip empties it. On mesh runs the extents snap
    to multiples of _mesh_quanta: grown toward hi, then lo, inside the
    nesting window, else left as they are (shrinking could drop tagged
    cells), as varden_tpu does."""
    dn_parent = [s * 2 ** parent_depth for s in sim.n_cell]
    quanta = _mesh_quanta(sim)
    lo, hi = [], []
    for d in range(sim.dm):
        dn_f = 2 * dn_parent[d]
        pl = 2 * (parent.lo[d] + NEST_BUFFER) if parent.lo[d] > 0 else 0
        ph = 2 * (parent.hi[d] - NEST_BUFFER) \
            if parent.hi[d] < dn_parent[d] else dn_f
        l = max(int(lo_f[d]), pl, 0)
        h = min(int(hi_f[d]), ph, dn_f)
        if h - l < 2 * QUANT:
            mid = (l + h) // 2
            l = max(min(l, mid - QUANT), pl, 0)
            h = min(max(h, mid + QUANT), ph, dn_f)
        if h - l <= 0:
            return None
        if quanta is not None and quanta[d] > 1 and (h - l) % quanta[d]:
            q = quanta[d]
            want = -((-(h - l)) // q) * q
            h2 = min(l + want, ph, dn_f)
            l2 = max(h2 - want, pl, 0)
            if (h2 - l2) % q == 0 and h2 - l2 > 0:
                l, h = l2, h2
        lo.append(l)
        hi.append(h)
    return LevelSpec(tuple(lo), tuple(h - l for l, h in zip(lo, hi)))


def _overlap_cells(spec: LevelSpec, lo_f, hi_f) -> int:
    v = 1
    for d in range(len(lo_f)):
        w = min(spec.hi[d], int(hi_f[d])) - max(spec.lo[d], int(lo_f[d]))
        if w <= 0:
            return 0
        v *= w
    return v


def compute_tags(sim: Sim, geom: MLGeom, states: List[State]):
    """The tag arrays compute_tree consumes (nodes of depth < max_levs - 1),
    as host numpy booleans: one device-to-host copy per node."""
    return {i: _tags(sim, geom, i, states[i].s[0])
            for i in range(geom.nlev)
            if geom.depth[i] < sim.cfg.max_levs - 1}


def _tags(sim: Sim, geom: MLGeom, i, rho):
    """Node i's tags on the host, whole (gathered from the blocks)."""
    t = problems.tag_cells(sim, rho, geom.depth[i]).to(rho.dtype)
    return geom.gather(i, t).cpu().numpy() > 0.5


def _children_of_depth(sim: Sim, specs, depth, d, cand):
    """Nest merged candidate boxes into the depth-d patch they overlap most:
    {parent node: [LevelSpec, ...]}."""
    nodes_d = [j for j in range(len(specs)) if depth[j] == d]
    children = {}
    for lo_f, hi_f in _merge_near(cand, MERGE_GAP):
        best, ov = None, 0
        for j in nodes_d:
            o = _overlap_cells(
                LevelSpec(tuple(2 * l for l in specs[j].lo),
                          tuple(2 * n for n in specs[j].n)), lo_f, hi_f)
            if o > ov:
                best, ov = j, o
        if best is None:
            continue
        child = _nest_into(sim, lo_f, hi_f, specs[best], d)
        if child is not None:
            children.setdefault(best, []).append(child)
    return children


def _merged_children(children, j):
    """A late clip can re-overlap siblings: merge those."""
    for lo, hi in _merge_near([(c.lo, c.hi) for c in children[j]], 0):
        yield LevelSpec(tuple(int(v) for v in lo),
                        tuple(int(h - l) for l, h in zip(lo, hi)))


def compute_tree(sim: Sim, geom: MLGeom, states: List[State], tags=None):
    """New patch tree from density tagging of the current states
    (regrid.f90:131-202 loop, with FBoxLib's make_new_grids clustering):
    each depth-d node's tags cluster into boxes; the boxes of all of a
    depth's nodes merge into isolated patches (gap >= MERGE_GAP fine cells)
    and nest into the new depth-d patch with the largest overlap.

    Returns (specs, parent, depth) lists, depth-sorted (node 0 = root)."""
    buf = max(sim.cfg.amr_buf_width, 2)
    slack = max(int(sim.cfg.regrid_slack), 0)
    slack = -(-slack // QUANT) * QUANT if slack else 0  # keep QUANT alignment
    if tags is None:
        tags = compute_tags(sim, geom, states)
    specs, parent, depth = [geom.specs[0]], [-1], [0]
    for d in range(sim.cfg.max_levs - 1):
        old_nodes = [i for i in range(geom.nlev) if geom.depth[i] == d
                     and i < len(states) and i in tags]
        if not old_nodes:
            break
        cand = []
        for i in old_nodes:
            cand += _child_boxes(sim, np.asarray(tags[i]), geom.specs[i], buf)
        if slack:
            # grow candidates so that the feature can move within the slack
            # before a new geometry is needed
            cand = [(np.asarray(lo) - slack, np.asarray(hi) + slack)
                    for lo, hi in cand]
        children = _children_of_depth(sim, specs, depth, d, cand)
        added = False
        for j in sorted(children):
            for spec in _merged_children(children, j):
                specs.append(spec)
                parent.append(j)
                depth.append(d + 1)
                added = True
        if not added:
            break
    return specs, parent, depth


def geom_covers(geom: MLGeom, specs, parent, depth, waste: float) -> bool:
    """Regrid hysteresis test: the CURRENT hierarchy still serves if every
    newly computed patch nests inside a current patch of the same depth and
    the current hierarchy is not wastefully large (< waste x the needed
    fine cells)."""
    dm = geom.dm
    for i in range(1, len(specs)):
        lo, hi = specs[i].lo, specs[i].hi
        if not any(geom.depth[j] == depth[i] and
                   all(geom.specs[j].lo[t] <= lo[t] and
                       hi[t] <= geom.specs[j].hi[t] for t in range(dm))
                   for j in range(1, geom.nlev)):
            return False
    ndepth = max([geom.ndepth - 1] + list(depth))
    for d in range(1, ndepth + 1):
        need = sum(math.prod(specs[i].n) for i in range(len(specs))
                   if depth[i] == d)
        have = sum(math.prod(geom.specs[j].n) for j in range(geom.nlev)
                   if geom.depth[j] == d)
        if need > 0 and have > waste * need:
            return False
        if need == 0 and have > 0:
            return False  # the feature vanished at this depth: rebuild
    return True


def _interp_block(geom: MLGeom, c, parent_t):
    """Rank's block of node ``c`` interpolated (limited slopes) from its
    parent's blocks: the window of the block's coarse image with one cell
    of slope halo, cut to the parent (whose outermost cells keep zero
    slope, as when the whole parent is prolonged)."""
    dm = geom.dm
    pn = geom.specs[geom.parent[c]].n

    def win(r):
        lo, hi = child_image(geom, c, r)
        return (tuple(max(l - 1, 0) for l in lo),
                tuple(min(h + 1, n) for h, n in zip(hi, pn)))

    w = halo.fetch(parent_t, geom.decs[geom.parent[c]], win)
    up = prolong_cells(w, dm)
    wlo = win(pmesh.rank())[0]
    ilo = child_image(geom, c, pmesh.rank())[0]
    sl = (slice(None),) * (up.ndim - dm) + tuple(
        slice(2 * (i - l), 2 * (i - l) + n)
        for i, l, n in zip(ilo, wlo, geom.bn(c)))
    return up[sl].clone()


def build_level_data(sim: Sim, old_geom: MLGeom, states: List[State],
                     new_geom: MLGeom) -> List[State]:
    """Move the state onto the new patch tree: interpolate each node from
    its (already built) parent, copy where old same-depth patches overlap
    (regrid.f90:274-341), nodal-prolong p. Under a mesh each rank builds
    its blocks, fetching the parent's and the old patches' parts."""
    from .solve import _prolonged
    dm = sim.dm
    new_states = [states[0]]
    for c in range(1, new_geom.nlev):
        spec = new_geom.specs[c]
        parent = new_states[new_geom.parent[c]]
        u, s, gp = (_interp_block(new_geom, c, parent.u),
                    _interp_block(new_geom, c, parent.s),
                    _interp_block(new_geom, c, parent.gp))
        p = _prolonged(new_geom, c, parent.p).clone()
        blo, bn = new_geom.blo(c), new_geom.bn(c)

        # copy the overlap from every old same-depth patch that intersects
        for o in range(1, old_geom.nlev):
            if old_geom.depth[o] != new_geom.depth[c] or o >= len(states):
                continue
            ospec = old_geom.specs[o]
            if any(min(spec.hi[d], ospec.hi[d]) <= max(spec.lo[d],
                                                       ospec.lo[d])
                   for d in range(dm)):
                continue

            def box(r, _o=ospec):
                dec = new_geom.decs[c]
                glo = spec.lo if dec is None else dec.of_rank(r).glo
                lo = [max(glo[d], _o.lo[d]) for d in range(dm)]
                hi = [min(glo[d] + bn[d], _o.hi[d]) for d in range(dm)]
                if any(h <= l for l, h in zip(lo, hi)):
                    return None
                return (tuple(l - ol for l, ol in zip(lo, _o.lo)),
                        tuple(h - ol for h, ol in zip(hi, _o.lo)))

            old = states[o]
            got = halo.fetch(torch.cat([old.u, old.s, old.gp]),
                             old_geom.decs[o], box)
            mine = box(pmesh.rank())
            if got is None:
                continue
            dst = (slice(None),) + tuple(
                slice(l + ol - b, h + ol - b)
                for l, h, ol, b in zip(mine[0], mine[1], ospec.lo, blo))
            u[dst] = got[:dm]
            s[dst] = got[dm:dm + sim.nscal]
            gp[dst] = got[dm + sim.nscal:]
        new_states.append(State(u=u, s=s, gp=gp, p=p))
    return new_states


def _init_block(sim: Sim, geom: MLGeom, i) -> State:
    """initdata on the rank's block of node i (the whole node when it is
    not decomposed)."""
    spec = geom.specs[i]
    if i == 0 and geom.decs[0] is None:
        return problems.initdata(sim)
    if geom.decs[i] is None:
        return problems.initdata_on_spec(sim, spec, geom.depth[i])
    st = problems.initdata_on_spec(sim, LevelSpec(geom.blo(i), geom.bn(i)),
                                   geom.depth[i])
    return State(u=st.u, s=st.s, gp=st.gp, p=sim.zeros(geom.bnode_shape(i)))


def initialize_adaptive(sim: Sim) -> Tuple[MLGeom, List[State]]:
    """Adaptive patch-tree construction (initialize_with_adaptive_grids,
    initialize.f90:152-342): init level 0, tag, cluster into isolated
    patches, init each from fresh initdata at its own resolution, recurse
    per depth."""
    buf = max(sim.cfg.amr_buf_width, 2)
    specs, parent, depth = [domain_spec(sim.n_cell, 0)], [-1], [0]
    geom = MLGeom(sim, specs, parent, depth)
    states = [_init_block(sim, geom, 0)]
    for d in range(sim.cfg.max_levs - 1):
        cand = []
        for i in [i for i in range(len(specs)) if depth[i] == d]:
            tags = _tags(sim, geom, i, states[i].s[0])
            cand += _child_boxes(sim, tags, specs[i], buf)
        children = _children_of_depth(sim, specs, depth, d, cand)
        added = False
        for j in sorted(children):
            for spec in _merged_children(children, j):
                specs.append(spec)
                parent.append(j)
                depth.append(d + 1)
                added = True
        if not added:
            break
        geom = MLGeom(sim, specs, parent, depth)
        states += [_init_block(sim, geom, i)
                   for i in range(len(states), len(specs))]
    return MLGeom(sim, specs, parent, depth), states


def parse_fixed_grids(path: str, dm: int):
    """Parse a fixed-grids file (the read_a_hgproj_grid format the
    reference consumes at initialize.f90:113): first line the number of
    levels; then per fine level a box count followed by box lines
    ``((lo..) (hi..) (t..))``. Returns per fine level a list of even-aligned
    LevelSpec boxes (boxes closer than MERGE_GAP fine cells merge into one
    isolated patch)."""
    box_re = re.compile(r"\(\(([^)]*)\)\s*\(([^)]*)\)")
    with open(path) as f:
        lines = [ln.strip() for ln in f.read().split("\n") if ln.strip()]
    nlev = int(lines[0].split()[0])
    idx = 1
    out = []
    for _ in range(nlev - 1):
        if re.fullmatch(r"\d+", lines[idx]):  # optional box-count line
            nbox = int(lines[idx])
            idx += 1
        else:
            nbox = 1
        boxes = []
        for _b in range(nbox):
            m = box_re.search(lines[idx])
            idx += 1
            blo = [int(v) for v in m.group(1).split(",")[:dm]]
            bhi = [int(v) for v in m.group(2).split(",")[:dm]]
            # even alignment for ratio-2 hierarchies
            boxes.append((np.asarray([(v // 2) * 2 for v in blo]),
                          np.asarray([-((-(v + 1)) // 2) * 2 for v in bhi])))
        merged = _merge_near(boxes, MERGE_GAP)
        if len(merged) < len(boxes):
            print(f"note: fixed-grids level: {len(boxes)} boxes merged into "
                  f"{len(merged)} isolated patch(es) (gap < {MERGE_GAP})")
        out.append([LevelSpec(tuple(int(v) for v in lo),
                              tuple(int(h - l) for l, h in zip(lo, hi)))
                    for lo, hi in merged])
    return out


def initialize_fixed(sim: Sim) -> Tuple[MLGeom, List[State]]:
    """Fixed-grids patch-tree construction (initialize_with_fixed_grids,
    initialize.f90:93-150); each box becomes a patch parented to the
    previous-depth patch with the largest overlap. The file's first level
    entry describes the reference's level 2."""
    specs, parent, depth = [domain_spec(sim.n_cell, 0)], [-1], [0]
    for li, boxes in enumerate(parse_fixed_grids(sim.cfg.fixed_grids,
                                                 sim.dm)):
        d = li + 1
        parents_d = [j for j in range(len(specs)) if depth[j] == d - 1]
        for spec in boxes:
            best, ov = None, 0
            for j in parents_d:
                o = _overlap_cells(
                    LevelSpec(tuple(2 * l for l in specs[j].lo),
                              tuple(2 * n for n in specs[j].n)),
                    spec.lo, spec.hi)
                if o > ov:
                    best, ov = j, o
            if best is None:
                print(f"WARNING: fixed-grids box {spec.lo}+{spec.n} at level "
                      f"{d + 1} nests in no parent patch; dropped")
                continue
            specs.append(spec)
            parent.append(best)
            depth.append(d)
    geom = MLGeom(sim, specs, parent, depth)
    return geom, [_init_block(sim, geom, i) for i in range(len(specs))]


def write_grids(path: str, geom: MLGeom, istep: int):
    """Append the current box hierarchy (the grdlog of varden.f90:622-663);
    rank 0 writes it."""
    if not pmesh.is_io_proc():
        return
    with open(path, "a") as f:
        f.write(f"step {istep}: {geom.ndepth} levels, {geom.nlev} boxes\n")
        for d in range(geom.ndepth):
            for i in geom.nodes_at(d):
                spec = geom.specs[i]
                hi = tuple(h - 1 for h in spec.hi)
                f.write(f"  level {d + 1}: "
                        f"(({','.join(map(str, spec.lo))}) "
                        f"({','.join(map(str, hi))}))\n")
