"""Simulation context and level state (counterpart of varden_tpu.state).

The reference's multifab state (make_new_state, src/initialize.f90:344-366):
u (dm comps), s (nscal comps), gp (dm comps) cell-centered, p node-centered.
Ghosts are derived, so ``State`` holds interior-only tensors; ``Sim`` holds the
static metadata (geometry, BC tables, device, dtype).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import bc as bc_mod
from .config import OUTLET, PERIODIC, VardenConfig
from .solvers import nodal
from .solvers.mg import BOTTOM_METHODS


@dataclasses.dataclass
class State:
    u: torch.Tensor    # (dm, *n) cell-centered velocity
    s: torch.Tensor    # (nscal, *n) density + tracers
    gp: torch.Tensor   # (dm, *n) cell-centered pressure gradient
    p: torch.Tensor    # node-centered pressure (node_shape)


def resolve_device(device=None) -> torch.device:
    """The device a run uses: the card unless the caller names another.
    Raises when no card is present and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "varden_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        device = "cuda"
    return torch.device(device)


class Sim:
    """Static per-run context: geometry, BC tables, component maps, and the
    device and dtype every tensor of the run lives in.

    With ``decomp`` (a parallel.mesh.Decomp) the Sim is one rank's view of
    a decomposed level: ``n_cell`` is the rank's block, ``pmask`` holds only
    the periodic axes that are not split, and on the block's internal faces
    ``phys_bc`` and ``adv_bc`` say "no physical boundary" (PERIODIC,
    ADV_INTERIOR): the ghost fills take those faces from the neighbours.
    ``ell_bc`` keeps the level's codes, and the solvers read the internal
    faces from ``dec``."""

    def __init__(self, cfg: VardenConfig, device=None, decomp=None):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dm = cfg.dm
        self.dec = decomp
        # the ranks a multi-level run's patches are decomposed over (0: one
        # rank); its Sim holds the whole domain and fill.MLGeom the blocks
        self.ml_ranks = 0
        self.n_cell = cfg.n_cell if decomp is None else decomp.n
        self.dx = cfg.dx
        self.pmask = cfg.pmask if decomp is None else decomp.local_pmask
        self.phys_bc = cfg.phys_bc
        self.adv_bc = bc_mod.adv_bc_table(cfg)
        self.ell_bc = bc_mod.ell_bc_table(cfg)
        if decomp is not None:
            inner = [(d, s) for d in range(self.dm) for s in range(2)
                     if decomp.internal(d, s)]
            self.phys_bc = tuple(
                tuple(PERIODIC if (d, s) in inner else cfg.phys_bc[d][s]
                      for s in range(2)) for d in range(self.dm))
            for comp in self.adv_bc:
                for d, s in inner:
                    comp[d][s] = bc_mod.ADV_INTERIOR
        self.bvals = bc_mod.bc_values(cfg)
        self.ng = cfg.ng_cell
        self.nscal = cfg.nscal
        self.press_comp = self.dm + self.nscal
        self.extrap_comp = self.dm + self.nscal + 1
        self.dtype = cfg.torch_dtype
        # bottom-solver selection, honoring the reference's integer codes
        # (mg_bottom_solver/hg_bottom_solver, _parameters:55-57)
        self.mg_bottom = BOTTOM_METHODS.get(cfg.mg_bottom_solver, "dense")
        self.hg_bottom = BOTTOM_METHODS.get(cfg.hg_bottom_solver, "dense")

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)

    def tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    # component-indexed helpers -------------------------------------------
    def eps(self, f64_val: float) -> float:
        """Solver tolerance adapted to the compute dtype: the reference's
        f64 eps schedule (macproject.f90:77-93) or a float32-feasible
        floor."""
        if self.dtype == torch.float64:
            return f64_val
        return max(f64_val, 2.0e-5)

    def scal_comp(self, i):
        return self.dm + i

    def node_shape(self) -> Tuple[int, ...]:
        return nodal.node_shape(self.n_cell, self.pmask)

    def nodal_mask(self) -> Optional[torch.Tensor]:
        """Dirichlet node mask for the hg solve: 0 on OUTLET boundary nodes
        (None where the level has no outlet: on a decomposed level every
        rank takes the same solver path, with or without outlet nodes of
        its own)."""
        if not any(OUTLET in pair for pair in self.cfg.phys_bc):
            return None
        mask = torch.ones(self.node_shape(), dtype=self.dtype,
                          device=self.device)
        for d in range(self.dm):
            for side in range(2):
                if self.phys_bc[d][side] == OUTLET:
                    sl = [slice(None)] * self.dm
                    sl[d] = slice(0, 1) if side == 0 else slice(-1, None)
                    mask[tuple(sl)] = 0.0
        return mask

    # ghost fills ----------------------------------------------------------
    def fill_comp(self, f: torch.Tensor, comp: int, ng: int) -> torch.Tensor:
        """Pad one variable (by global component index) with ng ghosts."""
        return bc_mod.fill_ghost(f, ng, self.adv_bc[comp],
                                 self.bvals[comp] if comp < len(self.bvals)
                                 else None,
                                 self.pmask, self.dm, dec=self.dec)

    def fill_vel(self, u: torch.Tensor, ng: int = None) -> torch.Tensor:
        ng = self.ng if ng is None else ng
        return torch.stack([self.fill_comp(u[d], d, ng) for d in range(self.dm)])

    def fill_scal(self, s: torch.Tensor, ng: int = None) -> torch.Tensor:
        ng = self.ng if ng is None else ng
        return torch.stack([self.fill_comp(s[i], self.dm + i, ng)
                            for i in range(s.shape[0])])

    def fill_extrap(self, f: torch.Tensor, ng: int) -> torch.Tensor:
        """Generic-extrap fill used for forcing terms (FOEXTRAP at walls)."""
        if f.ndim == self.dm:
            return self.fill_comp(f, self.extrap_comp, ng)
        return torch.stack([self.fill_comp(f[c], self.extrap_comp, ng)
                            for c in range(f.shape[0])])


_FIELDS = ("u", "s", "gp", "p")


def state_from_numpy(sim: Sim, arrays: Dict[str, np.ndarray],
                     hints: Dict[str, np.ndarray] = None):
    """Carry a state (u, s, gp, p as numpy arrays, e.g. from a varden_tpu
    State) and optional warm-start hints onto ``sim``'s device and dtype.
    Returns (State, hints dict of tensors or None)."""
    st = State(**{k: sim.tensor(arrays[k]) for k in _FIELDS})
    h = None if hints is None else {k: sim.tensor(v) for k, v in hints.items()}
    return st, h


def state_to_numpy(state: State, hints: Dict[str, torch.Tensor] = None):
    """Inverse of state_from_numpy: (dict of numpy arrays, hints or None)."""
    arrs = {k: getattr(state, k).detach().cpu().numpy() for k in _FIELDS}
    h = None if hints is None else {k: v.detach().cpu().numpy()
                                    for k, v in hints.items()}
    return arrs, h
