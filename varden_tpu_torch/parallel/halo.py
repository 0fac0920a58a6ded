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
is the transport of such runs, not a fallback. ``exchanges`` and
``reductions`` count the calls, their bytes and their seconds, in the
style of the kernels' ``.launches``.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Decomp


class Counter:
    """Calls, bytes sent by this rank, and host seconds spent."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.count = 0
        self.bytes = 0
        self.seconds = 0.0

    def as_dict(self):
        return {"count": self.count, "bytes": self.bytes,
                "seconds": self.seconds}


exchanges = Counter()
reductions = Counter()


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
        coords = (r // dec.mesh[1], r % dec.mesh[1]) + (0,) * (dm - 2)
        sl = [slice(None)] * len(lead)
        for d in range(dm):
            lo = coords[d] * dec.n[d]
            hi = min(lo + dec.n[d] + extra[d], out.shape[len(lead) + d])
            sl.append(slice(lo, hi))
            part = part.narrow(len(lead) + d, 0, hi - lo)
        out[tuple(sl)] = part
    reductions.count += 1
    reductions.bytes += src.numel() * src.element_size()
    reductions.seconds += time.perf_counter() - t0
    return out
