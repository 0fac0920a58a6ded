"""Halo exchange and reductions between the ranks of a decomposed level
(the roles of FBoxLib's multifab_fill_boundary and parallel_reduce, which
XLA's partitioner plays for varden_tpu).

``exchange`` gives a rank the ghost slabs of its internal faces along one
axis: the last entries its lo neighbour owns and the first ones its hi
neighbour owns. Callers go axis by axis, x first, each on the tensor
already grown along the earlier axes, so the corners come along. A tensor
whose entries along the axis sit on faces or nodes (``shared``) holds
n + 1 of them, the last shared with, and owned by, the hi neighbour. The
passes that make such entries (the Godunov faces, the MAC update, the
nodal sweeps) run on both ranks from the same exchanged cells, so both
hold the same value of a shared entry; the owner's copy counts where a sum
over the level needs it (the nodal means).

Transport: NCCL moves CUDA tensors itself. Gloo, which this package uses
for several ranks on one card and on the CPU, takes CUDA tensors in
all_reduce and all_gather but refuses them in send and recv, so the
exchange moves a CUDA slab through pinned host buffers: it is copied to
the host, sent, received into a host buffer and copied to the card. That
is the transport of such runs, not a fallback. ``exchanges``,
``reductions`` and ``copies`` count the calls, their bytes and their
seconds, in the style of the kernels' ``.launches``.

``fetch`` and ``put`` are BoxLib's parallel copy between decompositions,
which the coarse-fine coupling of a decomposed AMR hierarchy runs on: every
rank asks for a box of a decomposed patch (``fetch``) and receives only its
intersections with the other ranks' blocks, or writes (adds) a box it
computed into the ranks that hold it (``put``). The pattern comes from the
Decomps and the boxes alone, which every rank computes for every rank, so
no request travels; each pair of ranks exchanges at most one message a
call. ``copies.elements`` counts the entries a rank received from others.
"""
from __future__ import annotations

import itertools
import math
import time
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Decomp, rank as rank_


class Counter:
    """Calls, bytes sent by this rank, and host seconds spent."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.count = 0
        self.bytes = 0
        self.elements = 0
        self.seconds = 0.0

    def as_dict(self):
        return {"count": self.count, "bytes": self.bytes,
                "elements": self.elements, "seconds": self.seconds}


exchanges = Counter()
reductions = Counter()
copies = Counter()


def _staged(t: torch.Tensor) -> bool:
    """Whether ``t`` is sent through a host buffer (gloo's send and recv
    refuse CUDA tensors)."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def exchange(f: torch.Tensor, dec: Decomp, d: int, k_lo: int, k_hi: int,
             shared: bool = False
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The lo ghost slab (``k_lo`` deep, from the lo neighbour) and the hi
    one (``k_hi`` deep, from the hi neighbour) of ``f`` along spatial axis
    ``d`` of ``dec``; None on a side with no neighbour. Every rank of the
    group calls it with the same depths."""
    if not dec.split(d):
        return None, None
    t0 = time.perf_counter()
    ax = f.ndim - dec.dm + d
    own = f.shape[ax] - (1 if shared else 0)
    lo_r, hi_r = dec.nbr(d, 0), dec.nbr(d, 1)
    staged = _staged(f)
    sends, recvs = [], []
    # my head is my lo neighbour's hi ghost, my tail its hi neighbour's lo
    # ghost; tags keep the two apart where both neighbours are one rank
    if lo_r is not None and k_hi:
        sends.append((f.narrow(ax, 1 if shared else 0, k_hi), lo_r, 0))
    if hi_r is not None and k_lo:
        sends.append((f.narrow(ax, own - k_lo, k_lo), hi_r, 1))
    out = [None, None]
    for side, peer, k, tag in ((1, hi_r, k_hi, 0), (0, lo_r, k_lo, 1)):
        if peer is not None and k:
            shape = list(f.shape)
            shape[ax] = k
            buf = torch.empty(shape, dtype=f.dtype,
                              device="cpu" if staged else f.device,
                              pin_memory=staged)
            recvs.append((buf, peer, tag, side))
    ops = [dist.P2POp(dist.isend, _host(s) if staged else s.contiguous(),
                      peer, tag=tag) for s, peer, tag in sends]
    ops += [dist.P2POp(dist.irecv, buf, peer, tag=tag)
            for buf, peer, tag, _side in recvs]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    for buf, _peer, _tag, side in recvs:
        out[side] = buf.to(f.device) if staged else buf
    exchanges.count += 1
    exchanges.bytes += sum(s.numel() * s.element_size() for s, _, _ in sends)
    exchanges.seconds += time.perf_counter() - t0
    return out[0], out[1]


def extend(f: torch.Tensor, dec: Decomp, k: int,
           shared: Sequence[bool] = None) -> torch.Tensor:
    """``f`` grown by ``k`` entries on every internal face, axis by axis
    (``shared[d]``: the tensor holds n + 1 entries along axis d)."""
    for d in range(dec.dm):
        lo, hi = exchange(f, dec, d, k, k, bool(shared and shared[d]))
        ax = f.ndim - dec.dm + d
        f = torch.cat([t for t in (lo, f, hi) if t is not None], dim=ax)
    return f


def crop(f: torch.Tensor, dec: Decomp, k: int) -> torch.Tensor:
    """Undo ``extend``: drop ``k`` entries on every internal face."""
    for d in range(dec.dm):
        ax = f.ndim - dec.dm + d
        lo = k if dec.internal(d, 0) else 0
        hi = k if dec.internal(d, 1) else 0
        f = f.narrow(ax, lo, f.shape[ax] - lo - hi)
    return f


def _reduce(t: torch.Tensor, op) -> torch.Tensor:
    t0 = time.perf_counter()
    out = t.clone()
    dist.all_reduce(out, op=op)
    reductions.count += 1
    reductions.bytes += out.numel() * out.element_size()
    reductions.seconds += time.perf_counter() - t0
    return out


def all_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the ranks (exact)."""
    return _reduce(t, dist.ReduceOp.MAX)


def all_min(t: torch.Tensor) -> torch.Tensor:
    return _reduce(t, dist.ReduceOp.MIN)


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The elementwise sum over the ranks: the one reduction whose result
    depends on the decomposition, by roundoff."""
    return _reduce(t, dist.ReduceOp.SUM)


def gather(loc: torch.Tensor, dec: Decomp, extra: Sequence[int] = None,
           glob_extra: Sequence[int] = None) -> torch.Tensor:
    """The whole level on every rank from each rank's block (exact).
    ``extra[d]``: the block holds n + extra[d] entries along axis d (faces
    or nodes); ``glob_extra[d]``: the level holds N + glob_extra[d] (a
    periodic node axis holds N, the last block's last node wrapping to the
    first)."""
    dm = dec.dm
    extra = extra or (0,) * dm
    glob_extra = glob_extra or extra
    t0 = time.perf_counter()
    src = loc.contiguous()
    parts = [torch.empty_like(src) for _ in range(dec.nranks)]
    dist.all_gather(parts, src)
    lead = loc.shape[:loc.ndim - dm]
    out = torch.empty(tuple(lead) + tuple(
        g + e for g, e in zip(dec.n_glob, glob_extra)), dtype=loc.dtype,
        device=src.device)
    for r, part in enumerate(parts):
        rlo = dec.of_rank(r).lo
        sl = [slice(None)] * len(lead)
        for d in range(dm):
            lo = rlo[d]
            hi = min(lo + dec.n[d] + extra[d], out.shape[len(lead) + d])
            sl.append(slice(lo, hi))
            part = part.narrow(len(lead) + d, 0, hi - lo)
        out[tuple(sl)] = part
    reductions.count += 1
    reductions.bytes += src.numel() * src.element_size()
    reductions.seconds += time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# parallel copy between decompositions
# ---------------------------------------------------------------------------
# Entries of a decomposed patch tensor are indexed in the patch: cells
# 0..N-1 along an axis, faces (along their own axis) and nodes 0..N (N - 1
# on a periodic node axis, whose node N is node 0). A block holds its
# entries from dec.lo - pad (``pad`` ghost entries on every side, which a
# padded tensor holds) for as many as its tensor has; the blocks of one
# patch all have one shape. The entry a fetch reads has one owner: the
# block it lies in (the last one for the shared end entry), the first and
# last block also owning the ghosts beyond the patch, and along a
# replicated axis the requester's own copy.

def ext_of(kind, dec):
    """Entries past the N cells of the whole patch per axis: ``kind``
    "cell", "node" (none on a periodic axis), or an int d (faces along
    axis d)."""
    dm = dec.dm
    if kind == "cell":
        return (0,) * dm
    if kind == "node":
        return tuple(0 if p else 1 for p in dec.pmask)
    return tuple(int(t == kind) for t in range(dm))


def _rank_coords(dec: Decomp, r: int):
    my = dec.mesh[1]
    return (r // my, r % my) + (0,) * (dec.dm - 2)


def _own(dec: Decomp, r: int, d: int, total: int, pad: int):
    """[lo, hi) of the entries along axis d that rank r's block owns."""
    if not dec.split(d):
        return -pad, total + pad
    b, c = dec.n[d], _rank_coords(dec, r)[d]
    return (-pad if c == 0 else c * b,
            total + pad if c == dec.mesh[d] - 1 else (c + 1) * b)


def _segments(a, b, total, wrap):
    """Split the requested entries [a, b) into (first entry, offset in the
    request, count) runs, wrapped into [0, total) where ``wrap``."""
    if not wrap:
        return [(a, 0, b - a)] if b > a else []
    out, i = [], a
    while i < b:
        g = i % total
        k = min(b - i, total - g)
        out.append((g, i - a, k))
        i += k
    return out


def _fetch_pieces(dec: Decomp, s: int, t: int, box, total, pad, wrap):
    """The pieces of rank t's box that rank s owns: per axis a list of
    (first entry, offset in the box, count), one product of them each."""
    if dec is not None and dec.rep:
        cs, ct = _rank_coords(dec, s), _rank_coords(dec, t)
        if any(dec.rep[d] and cs[d] != ct[d] for d in range(dec.dm)):
            return []
    axes = []
    for d in range(len(total)):
        if dec is None:
            olo, ohi = -pad, total[d] + pad
        else:
            olo, ohi = _own(dec, s, d, total[d], pad)
        segs = []
        for g, off, k in _segments(box[0][d], box[1][d], total[d],
                                   wrap[d]):
            lo, hi = max(g, olo), min(g + k, ohi)
            if hi > lo:
                segs.append((lo, off + lo - g, hi - lo))
        if not segs:
            return []
        axes.append(segs)
    return list(itertools.product(*axes))


def _move(sends, recvs, like):
    """One message per peer each way: ``sends`` {peer: [tensor]} flattened
    into one buffer, ``recvs`` {peer: numel}; returns {peer: flat tensor}.
    Staged through pinned host buffers where gloo carries CUDA tensors."""
    staged = _staged(like)
    ops, bufs = [], {}
    for peer, parts in sends.items():
        flat = torch.cat([p.reshape(-1) for p in parts])
        ops.append(dist.P2POp(dist.isend, _host(flat) if staged else flat,
                              peer))
    for peer, numel in recvs.items():
        bufs[peer] = torch.empty(numel, dtype=like.dtype,
                                 device="cpu" if staged else like.device,
                                 pin_memory=staged)
        ops.append(dist.P2POp(dist.irecv, bufs[peer], peer))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return {p: (b.to(like.device) if staged else b) for p, b in bufs.items()}


def _index(lead, dm, per_axis, base):
    return (slice(None),) * lead + tuple(
        slice(g - b, g - b + k) for (g, _o, k), b in zip(per_axis, base))


def _dst_index(lead, per_axis):
    return (slice(None),) * lead + tuple(slice(o, o + k)
                                         for (_g, o, k) in per_axis)


def fetch(src: torch.Tensor, dec: Optional[Decomp], box_of: Callable,
          kind="cell", pad: int = 0, wrap: bool = False) -> torch.Tensor:
    """The box ``box_of(rank())`` = (lo, hi) of the decomposed patch whose
    block ``src`` is (``pad`` ghost entries a side; leading axes pass
    through), in the patch's entry index (see ext_of for ``kind``). Every
    rank calls it, ``box_of(r)`` giving rank r's box (None: none); each
    receives the parts of its box that other ranks own and copies its own.
    ``wrap`` (per axis, or one for all): indices past a periodic axis wrap
    around it. With ``dec`` None (one rank) it is a slice. Returns None on
    a rank without a box."""
    me = 0 if dec is None else rank_()
    dm = len(box_of(me)[0]) if dec is None else dec.dm
    t0 = time.perf_counter()
    nr = 1 if dec is None else dec.nranks
    total = tuple(n + e for n, e in zip(
        src.shape[src.ndim - dm:] if dec is None else dec.n_glob,
        (0,) * dm if dec is None else ext_of(kind, dec)))
    if dec is None:
        total = tuple(t - 2 * pad for t in total)
    if isinstance(wrap, bool):
        wrap = (wrap,) * dm
    wr = tuple(wrap) if dec is None else tuple(
        w and p for w, p in zip(wrap, dec.pmask))
    lead = src.ndim - dm
    base_me = tuple(-pad for _ in range(dm)) if dec is None else \
        tuple(l - pad for l in dec.lo)
    my_box = box_of(me)
    out = None if my_box is None else src.new_empty(
        src.shape[:lead] + tuple(h - l for l, h in zip(*my_box)))
    sends, recvs, plans = {}, {}, {}
    for s in range(nr):
        if my_box is None:
            break
        if s == me:
            for pc in _fetch_pieces(dec, me, me, my_box, total, pad, wr):
                out[_dst_index(lead, pc)] = src[_index(lead, dm, pc,
                                                       base_me)]
            continue
        pcs = _fetch_pieces(dec, s, me, my_box, total, pad, wr)
        if pcs:
            plans[s] = pcs
            recvs[s] = sum(math.prod(k for _g, _o, k in pc)
                           for pc in pcs) * math.prod(src.shape[:lead])
    for t in range(nr):
        box = box_of(t) if t != me else None
        if box is None:
            continue
        pcs = _fetch_pieces(dec, me, t, box, total, pad, wr)
        if pcs:
            sends[t] = [src[_index(lead, dm, pc, base_me)] for pc in pcs]
    got = _move(sends, recvs, src) if nr > 1 else {}
    for s, flat in got.items():
        at = 0
        for pc in plans[s]:
            shape = src.shape[:lead] + tuple(k for _g, _o, k in pc)
            m = math.prod(shape)
            out[_dst_index(lead, pc)] = flat[at:at + m].reshape(shape)
            at += m
    copies.count += 1
    copies.elements += sum(recvs.values())
    copies.bytes += sum(sum(p.numel() for p in v)
                        for v in sends.values()) * src.element_size()
    copies.seconds += time.perf_counter() - t0
    return out


def _held(dec: Decomp, r: int, shape, total):
    """Per axis the runs (first entry, offset in the block, count) of the
    entries rank r's block holds (its tensor's trailing ``shape``, one for
    every block of a patch): a node past the end of a periodic axis is
    node 0 again."""
    lo = dec.of_rank(r).lo
    out = []
    for d in range(dec.dm):
        h0, h1 = lo[d], lo[d] + shape[d]
        runs = [(h0, 0, min(h1, total[d]) - h0)]
        if h1 > total[d]:
            runs.append((0, total[d] - h0, h1 - total[d]))
        out.append(runs)
    return out


def put(dst: torch.Tensor, dec: Optional[Decomp], box_of: Callable,
        data: Optional[torch.Tensor], add: bool = False,
        kind="cell") -> torch.Tensor:
    """Write (``add``: add) each rank's ``data``, the box ``box_of(r)`` of
    the decomposed patch whose block ``dst`` is (unpadded; leading axes
    pass through; ``kind`` as in fetch), into every block that holds a part
    of it, in place; returns ``dst``. Every rank calls it; a rank with
    ``box_of`` None gives nothing. The boxes of a ``put`` with ``add`` must
    not overlap."""
    me = rank_()
    t0 = time.perf_counter()
    if dec is None:
        box = box_of(0)
        if box is not None:
            idx = (slice(None),) * (dst.ndim - len(box[0])) + tuple(
                slice(l, h) for l, h in zip(*box))
            if add:
                dst[idx] += data
            else:
                dst[idx] = data
        return dst
    dm = dec.dm
    lead = dst.ndim - dm
    shape = dst.shape[lead:]
    total = tuple(n + e for n, e in zip(dec.n_glob, ext_of(kind, dec)))

    def pieces(s, t):
        """Per axis (first entry, offset in s's data, offset in t's
        block, count) runs; their products are the pieces."""
        box = box_of(s)
        if box is None:
            return []
        axes = []
        for d, runs in enumerate(_held(dec, t, shape, total)):
            segs = []
            for g, off, k in runs:
                lo, hi = max(box[0][d], g), min(box[1][d], g + k)
                if hi > lo:
                    segs.append((lo, lo - box[0][d], off + lo - g, hi - lo))
            if not segs:
                return []
            axes.append(segs)
        return list(itertools.product(*axes))

    def src_idx(per):
        return (slice(None),) * lead + tuple(slice(o, o + k)
                                             for _g, o, _h, k in per)

    def dst_idx(per):
        return (slice(None),) * lead + tuple(slice(h, h + k)
                                             for _g, _o, h, k in per)

    def apply(per, vals):
        if add:
            dst[dst_idx(per)] += vals
        else:
            dst[dst_idx(per)] = vals

    sends, recvs, plans = {}, {}, {}
    for t in range(dec.nranks):
        if t != me and data is not None:
            pcs = pieces(me, t)
            if pcs:
                sends[t] = [data[src_idx(per)] for per in pcs]
    for s in range(dec.nranks):
        pcs = pieces(s, me)
        if not pcs:
            continue
        if s == me:
            for per in pcs:
                apply(per, data[src_idx(per)])
            continue
        plans[s] = pcs
        recvs[s] = math.prod(dst.shape[:lead]) * sum(
            math.prod(k for _g, _o, _h, k in per) for per in pcs)
    got = _move(sends, recvs, dst)
    for s, flat in got.items():
        at = 0
        for per in plans[s]:
            shp = dst.shape[:lead] + tuple(k for _g, _o, _h, k in per)
            m = math.prod(shp)
            apply(per, flat[at:at + m].reshape(shp))
            at += m
    copies.count += 1
    copies.elements += sum(recvs.values())
    copies.bytes += sum(sum(p.numel() for p in v)
                        for v in sends.values()) * dst.element_size()
    copies.seconds += time.perf_counter() - t0
    return dst
