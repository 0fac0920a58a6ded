"""Problem initial data (counterpart of varden_tpu.problems).

Re-derivations of reference src/initdata.f90:130-306 (prob_types 1-4) and
src/tag_boxes.f90:16-216 (density-threshold tagging). The fields are
computed in float64 numpy and cast once to the run's dtype and device.
"""
from __future__ import annotations

import numpy as np
import torch

from .solvers import nodal
from .state import Sim, State


def _cell_coords(sim: Sim, include_prob_lo: bool, dx=None, n_cell=None,
                 lo=None):
    dx = sim.dx if dx is None else dx
    n_cell = sim.n_cell if n_cell is None else n_cell
    lo = (0,) * sim.dm if lo is None else lo
    axes = []
    for d in range(sim.dm):
        x = dx[d] * (lo[d] + np.arange(n_cell[d]) + 0.5)
        if include_prob_lo:
            x = sim.cfg.prob_lo[d] + x
        axes.append(x)
    return np.meshgrid(*axes, indexing="ij")


def _interface_h(x, prob_lo, prob_hi):
    """Rayleigh-Taylor interface perturbation (initdata.f90:195-200)."""
    L = prob_hi[0] - prob_lo[0]
    return (0.02 * np.sin(4.0 * np.pi * x * L) +
            0.01 * np.sin(8.0 * np.pi * x * L))


def initdata(sim: Sim, dx=None, n_cell=None, lo=None,
             node_shape=None) -> State:
    """Initial (u, s) for the configured prob_type; gp = p = 0.

    dx / n_cell / lo evaluate it on a fine AMR box (initdata_on_level,
    reference initdata.f90:19-59). On a decomposed level it is the rank's
    block, from the level's coordinates."""
    cfg = sim.cfg
    dm = sim.dm
    pt = cfg.prob_type
    if lo is None and sim.dec is not None:
        lo = sim.dec.lo
    n_cell = sim.n_cell if n_cell is None else n_cell
    box = dict(dx=dx, n_cell=n_cell, lo=lo)

    u = np.zeros((dm,) + tuple(n_cell))
    s = np.zeros((cfg.nscal,) + tuple(n_cell))

    if pt in (1, 2):
        coords = _cell_coords(sim, include_prob_lo=False, **box)
        blob = [0.5] * dm
        densfact = 2.0 if dm == 2 else 10.0
        blobrad = 0.1
        dist = np.sqrt(sum((coords[d] - blob[d]) ** 2 for d in range(dm)))
        rho = 1.0 + 0.5 * (densfact - 1.0) * (1.0 - np.tanh(30.0 * (dist - blobrad)))
        s[0] = rho
        if cfg.nscal > 1:
            s[1] = rho
        if pt == 2:
            u[0] = 1.0
    elif pt == 3:
        coords = _cell_coords(sim, include_prob_lo=True, **box)
        hperp = _interface_h(coords[0], cfg.prob_lo, cfg.prob_hi)
        if dm == 3:
            hperp = hperp + _interface_h(coords[1], cfg.prob_lo, cfg.prob_hi)
        vert = coords[-1]
        s[0] = 1.5 + 0.5 * np.tanh((vert - 0.5 - hperp) / 0.01)
    elif pt == 4:
        if dm != 3:
            raise ValueError("vortex tube is 3-D (initdata.f90:276-306)")
        eps_i, rho_i, beta_i = 0.05, 0.15, 15.0
        delta_i, kappa_i = 0.0333, 500.0
        coords = _cell_coords(sim, include_prob_lo=True, **box)
        x, y, z = [c - 0.5 for c in coords]
        r_yz = np.sqrt(y * y + z * z)
        u[0] = np.tanh((rho_i - r_yz) / delta_i)
        u[2] = eps_i * np.exp(-beta_i * (x * x + y * y))
        s[0] = 1.0
        if cfg.nscal > 1:
            s[1] = np.exp(-kappa_i * (rho_i - r_yz) ** 2)
    else:
        raise ValueError(f"Unsupported prob_type {pt}")

    if node_shape is None:
        node_shape = nodal.node_shape(tuple(n_cell), sim.pmask)
    return State(u=sim.tensor(u), s=sim.tensor(s),
                 gp=sim.zeros((dm,) + tuple(n_cell)), p=sim.zeros(node_shape))


def initdata_on_spec(sim: Sim, spec, level: int) -> State:
    """initdata evaluated on a fine-level box (initdata_on_level)."""
    dx_l = tuple(h / 2 ** level for h in sim.dx)
    dn = tuple(s * 2 ** level for s in sim.n_cell)
    pm = tuple(sim.pmask[d] and spec.lo[d] == 0 and spec.hi[d] == dn[d]
               for d in range(sim.dm))
    return initdata(sim, dx=dx_l, n_cell=spec.n, lo=spec.lo,
                    node_shape=nodal.node_shape(spec.n, pm))


def tag_cells(sim: Sim, rho: torch.Tensor, level: int) -> torch.Tensor:
    """Density-threshold tagging per level (reference tag_boxes.f90:51-216).
    level is 0-based (the reference's level 1 is 0 here). Returns a boolean
    tensor."""
    pt = sim.cfg.prob_type
    if pt in (1, 2):
        return rho > (1.01, 1.1, 1.5)[min(level, 2)]
    if pt == 3:
        return torch.logical_and(rho > 1.2, rho < 1.8)
    # prob_type 4: single-level in the reference configs; tag nothing
    return torch.zeros_like(rho, dtype=torch.bool)
