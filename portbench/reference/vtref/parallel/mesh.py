"""Rank bookkeeping (counterpart of varden_tpu.parallel.mesh).

varden_tpu shards every level over a 2-D ``(mx, my)`` device mesh of the
first two spatial axes and lets XLA's partitioner insert the halo exchanges
and the reductions. Here each rank of a torch.distributed group holds one
block of that mesh: ``Decomp`` says which block, where it sits in the
level, and which ranks hold the blocks beside it; parallel.halo moves the
ghost slabs between them. Rank r holds block (r // my, r % my), the order
in which varden_tpu's make_mesh lays its devices out.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def maybe_init_distributed(device=None, backend: Optional[str] = None) -> bool:
    """Join the run's process group: the reference's MPI_Init role
    (main.f90:13). Reads varden_tpu's variables (VARDEN_COORDINATOR or
    JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID) or
    torchrun's (MASTER_ADDR and MASTER_PORT, WORLD_SIZE, RANK). With none
    set it is a no-op and returns False; with a group already set up it
    returns True at once. ``backend`` defaults to NCCL when ``device`` is a
    CUDA device and gloo otherwise; gloo ranks may share one card."""
    env = os.environ
    addr = env.get("VARDEN_COORDINATOR") or env.get("JAX_COORDINATOR_ADDRESS")
    if not addr and env.get("MASTER_ADDR"):
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if not addr:
        return False
    if dist.is_initialized():
        return True
    world = int(env.get("JAX_NUM_PROCESSES") or env.get("WORLD_SIZE") or 0)
    if world <= 0:
        raise ValueError(f"coordinator {addr} is set but not the number of "
                         "processes (JAX_NUM_PROCESSES or WORLD_SIZE)")
    rank = int(env.get("JAX_PROCESS_ID") or env.get("RANK") or 0)
    cuda = device is not None and torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=f"tcp://{addr}",
                            world_size=world, rank=rank)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_io_proc() -> bool:
    """parallel_IOProcessor() equivalent (rank-0 I/O gating)."""
    return rank() == 0


def mesh_shape(n: int) -> Tuple[int, int]:
    """The (mx, my) factoring of n ranks: as square as possible, mx <= my
    (varden_tpu/parallel/mesh.py:56-65)."""
    mx = 1
    for f in range(int(n ** 0.5), 0, -1):
        if n % f == 0:
            mx = f
            break
    return (mx, n // mx)


# The smallest block, in cells along a split axis, that a multigrid level
# keeps on its rank: coarser levels are gathered onto every rank.
MIN_BLOCK = 4


@dataclasses.dataclass(frozen=True)
class Decomp:
    """One rank's block of a level (or of an AMR patch) of ``n_glob``
    cells split ``mesh[d]`` ways along each axis (1 on the axes that are
    not split), and its neighbours. A neighbour across a periodic seam is
    the wrapped rank; across a physical face there is none. ``coords`` is
    the rank's place in the mesh of ranks. An axis in ``rep`` is not split
    although the mesh has several ranks along it: every rank holds it whole
    (a patch axis that does not cut into even blocks). ``offset`` is the
    patch's first cell in its level's index space (0 for a whole level)."""
    n_glob: Tuple[int, ...]
    mesh: Tuple[int, ...]
    coords: Tuple[int, ...]
    pmask: Tuple[bool, ...]
    offset: Optional[Tuple[int, ...]] = None
    rep: Optional[Tuple[bool, ...]] = None

    @property
    def dm(self) -> int:
        return len(self.n_glob)

    @property
    def n(self) -> Tuple[int, ...]:
        """The block's cells per axis."""
        return tuple(g // m if self.split(d) else g
                     for d, (g, m) in enumerate(zip(self.n_glob, self.mesh)))

    @property
    def lo(self) -> Tuple[int, ...]:
        """The block's first cell in the patch."""
        return tuple(c * b if self.split(d) else 0
                     for d, (c, b) in enumerate(zip(self.coords, self.n)))

    @property
    def glo(self) -> Tuple[int, ...]:
        """The block's first cell in the level's index space."""
        off = self.offset or (0,) * self.dm
        return tuple(o + l for o, l in zip(off, self.lo))

    @property
    def primary(self) -> bool:
        """Whether this rank's copy of the replicated axes is the one that
        counts in a sum over the ranks (the first along each)."""
        return all(self.coords[d] == 0 for d in range(self.dm)
                   if self.rep and self.rep[d])

    def of_rank(self, r: int) -> "Decomp":
        """The same patch's block on rank ``r``."""
        my = self.mesh[1]
        return dataclasses.replace(
            self, coords=(r // my, r % my) + (0,) * (self.dm - 2))

    @property
    def nranks(self) -> int:
        out = 1
        for m in self.mesh:
            out *= m
        return out

    def split(self, d: int) -> bool:
        return self.mesh[d] > 1 and not (self.rep and self.rep[d])

    def rank_of(self, coords: Sequence[int]) -> int:
        return coords[0] * self.mesh[1] + coords[1]

    def nbr(self, d: int, side: int) -> Optional[int]:
        """The rank on the lo (side 0) or hi (side 1) face along axis d, or
        None where that face is physical or the axis is not split."""
        if not self.split(d):
            return None
        c = self.coords[d] + (1 if side else -1)
        if not 0 <= c < self.mesh[d]:
            if not self.pmask[d]:
                return None
            c %= self.mesh[d]
        coords = list(self.coords)
        coords[d] = c
        return self.rank_of(coords)

    def internal(self, d: int, side: int) -> bool:
        return self.nbr(d, side) is not None

    def seam(self, d: int, side: int) -> bool:
        """Whether the face crosses the level's periodic boundary to the
        wrapped rank."""
        edge = self.coords[d] == (self.mesh[d] - 1 if side else 0)
        return self.split(d) and self.pmask[d] and edge

    @property
    def local_pmask(self) -> Tuple[bool, ...]:
        """Periodicity that a rank applies by itself: a periodic axis that
        is split takes its wrap from the neighbours instead."""
        return tuple(p and not self.split(d)
                     for d, p in enumerate(self.pmask))

    def coarsen(self, fac: Sequence[int]) -> Optional["Decomp"]:
        """The same ranks on the level coarsened by ``fac`` per axis, or None
        where a block does not divide."""
        if any(b % f for b, f in zip(self.n, fac)):
            return None
        return dataclasses.replace(
            self, n_glob=tuple(g // f for g, f in zip(self.n_glob, fac)),
            offset=None if self.offset is None else tuple(
                o // f for o, f in zip(self.offset, fac)))

    def keeps_blocks(self) -> bool:
        """Whether a multigrid level of this shape stays on the ranks'
        blocks: every split axis even (so a block's red-black colours and
        restriction line up with the level's) and at least MIN_BLOCK."""
        return all(b % 2 == 0 and b >= MIN_BLOCK
                   for d, b in enumerate(self.n) if self.split(d))

    def block(self, g: torch.Tensor, nodal: bool = False) -> torch.Tensor:
        """This rank's block of a tensor of the whole level (cells, or with
        ``nodal`` its nodes: n + 1 along a split axis, the index past a
        periodic end wrapping to 0)."""
        for d in range(self.dm):
            if not self.split(d):
                continue
            ax = g.ndim - self.dm + d
            lo, b = self.lo[d], self.n[d]
            if not nodal:
                g = g.narrow(ax, lo, b)
            elif lo + b < g.shape[ax]:
                g = g.narrow(ax, lo, b + 1)
            else:
                g = torch.cat([g.narrow(ax, lo, b), g.narrow(ax, 0, 1)],
                              dim=ax)
        return g


def make_decomp(n_glob: Sequence[int], pmask: Sequence[bool], nranks: int,
                rank_: int) -> Decomp:
    """Rank ``rank_``'s block of a level split over ``mesh_shape(nranks)``
    on its first two axes."""
    dm = len(n_glob)
    mx, my = mesh_shape(nranks)
    mesh = (mx, my) + (1,) * (dm - 2)
    for d in range(dm):
        if n_glob[d] % mesh[d]:
            raise ValueError(f"{nranks} ranks split axis {d} {mesh[d]} ways, "
                             f"which does not divide its {n_glob[d]} cells")
    coords = (rank_ // my, rank_ % my) + (0,) * (dm - 2)
    return Decomp(tuple(n_glob), mesh, coords, tuple(pmask))


def make_patch_decomp(n: Sequence[int], offset: Sequence[int],
                      pmask: Sequence[bool], nranks: int, rank_: int,
                      min_block: int, name: str = "patch") -> Decomp:
    """Rank ``rank_``'s block of an AMR patch of ``n`` cells at ``offset``
    over the ranks' ``mesh_shape(nranks)``. A patch axis that does not cut
    into even blocks of at least ``min_block`` cells stays whole on every
    rank (replicated, computed redundantly), with a warning, as varden_tpu
    replicates a patch axis that its mesh axis does not divide
    (varden_tpu/parallel/mesh.py:141-176)."""
    dm = len(n)
    mx, my = mesh_shape(nranks)
    mesh = (mx, my) + (1,) * (dm - 2)
    rep = []
    for d in range(dm):
        m = mesh[d]
        b = n[d] // m
        ok = m == 1 or (n[d] % m == 0 and b % 2 == 0 and b >= min_block)
        rep.append(not ok)
        if not ok:
            warnings.warn(f"{name} (extent {tuple(n)}) replicates on mesh "
                          f"axis {d} (size {m}): its {n[d]} cells do not "
                          f"cut into even blocks of at least {min_block}")
    coords = (rank_ // my, rank_ % my) + (0,) * (dm - 2)
    return Decomp(tuple(n), mesh, coords, tuple(pmask),
                  offset=tuple(int(o) for o in offset),
                  rep=tuple(rep) if any(rep) else None)
