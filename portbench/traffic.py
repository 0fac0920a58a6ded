"""The one generator of every traffic mix: from a traffic file and
``--seed``, the seeded velocity perturbation added to the initial state and
the window step whose output the reference checks.

The perturbation is the same set of smooth modes for every seed (the
traffic file's ``modes`` and ``amplitude``); the seed draws only their
phases, so every seed gives the run the same sizes of work in another
arrangement. Each mode is a product over the axes of cos(2 pi k x + phase),
times sin(pi x) on each axis with walls, so that it vanishes there.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference.initdata import cell_axes, geometry


def _rng(seed: int, purpose: int):
    return np.random.default_rng([seed % (1 << 64), purpose])


def phases(seed: int, nmodes: int, dm: int = 3):
    """Phases (component, mode, axis) drawn from the seed."""
    return _rng(seed, 0).uniform(0.0, 2.0 * math.pi, size=(dm, nmodes, dm))


def check_step(seed: int, traffic) -> int:
    """The window step (0-based) whose output the reference checks."""
    return int(_rng(seed, 1).integers(0, traffic["check_steps"]))


def perturbation(seed, spec, n_cell, lo_idx, dx, prob_lo, prob_hi, pmask,
                 device):
    """The seeded velocity (3, *n_cell) in float64 on ``device``, on the box
    of ``n_cell`` cells from index ``lo_idx`` at spacing ``dx``."""
    modes = spec["modes"]
    ph = phases(seed, len(modes))
    axes = cell_axes(n_cell, lo_idx, dx, prob_lo, device)
    t = [(axes[d] - prob_lo[d]) / (prob_hi[d] - prob_lo[d]) for d in range(3)]
    env = [torch.ones_like(t[d]) if pmask[d] else torch.sin(math.pi * t[d])
           for d in range(3)]
    out = torch.zeros((3,) + tuple(n_cell), dtype=torch.float64,
                      device=device)
    for c in range(3):
        for j, k in enumerate(modes):
            w = [env[d] * torch.cos(2.0 * math.pi * k[d] * t[d] + ph[c, j, d])
                 for d in range(3)]
            out[c] += w[0][:, None, None] * w[1][None, :, None] \
                * w[2][None, None, :]
    return out * (spec["amplitude"] / len(modes))


def perturb_levels(seed, spec, kw, specs, us, device):
    """Each level's velocity plus the perturbation on its box: ``specs``
    the levels' (lo, n) in their own index spaces, level l refined 2^l."""
    n0, dx0, lo, hi, pmask = geometry(kw)
    out = []
    for lev, ((lo_idx, n), u) in enumerate(zip(specs, us)):
        dx = tuple(h / 2 ** lev for h in dx0)
        p = perturbation(seed, spec, n, lo_idx, dx, lo, hi, pmask, device)
        out.append(u + p.to(u.dtype))
    return out
