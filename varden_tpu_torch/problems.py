"""Problem initial data (counterpart of varden_tpu.problems).

Re-derivation of reference src/initdata.f90:130-306 (prob_types 1-4). The
fields are computed in float64 numpy and cast once to the run's dtype and
device.
"""
from __future__ import annotations

import numpy as np

from .solvers import nodal
from .state import Sim, State


def _cell_coords(sim: Sim, include_prob_lo: bool):
    axes = []
    for d in range(sim.dm):
        x = sim.dx[d] * (np.arange(sim.n_cell[d]) + 0.5)
        if include_prob_lo:
            x = sim.cfg.prob_lo[d] + x
        axes.append(x)
    return np.meshgrid(*axes, indexing="ij")


def _interface_h(x, prob_lo, prob_hi):
    """Rayleigh-Taylor interface perturbation (initdata.f90:195-200)."""
    L = prob_hi[0] - prob_lo[0]
    return (0.02 * np.sin(4.0 * np.pi * x * L) +
            0.01 * np.sin(8.0 * np.pi * x * L))


def initdata(sim: Sim) -> State:
    """Initial (u, s) for the configured prob_type; gp = p = 0."""
    cfg = sim.cfg
    dm = sim.dm
    pt = cfg.prob_type
    n_cell = sim.n_cell

    u = np.zeros((dm,) + tuple(n_cell))
    s = np.zeros((cfg.nscal,) + tuple(n_cell))

    if pt in (1, 2):
        coords = _cell_coords(sim, include_prob_lo=False)
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
        coords = _cell_coords(sim, include_prob_lo=True)
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
        coords = _cell_coords(sim, include_prob_lo=True)
        x, y, z = [c - 0.5 for c in coords]
        r_yz = np.sqrt(y * y + z * z)
        u[0] = np.tanh((rho_i - r_yz) / delta_i)
        u[2] = eps_i * np.exp(-beta_i * (x * x + y * y))
        s[0] = 1.0
        if cfg.nscal > 1:
            s[1] = np.exp(-kappa_i * (rho_i - r_yz) ** 2)
    else:
        raise ValueError(f"Unsupported prob_type {pt}")

    return State(u=sim.tensor(u), s=sim.tensor(s),
                 gp=sim.zeros((dm,) + tuple(n_cell)),
                 p=sim.zeros(nodal.node_shape(tuple(n_cell), sim.pmask)))
