"""Bytes, operations and the least time of the Godunov kernels' calls
(kernels 1 and 2), with the published peaks of the card.

Copied from chip_smoke.py (MEM_BYTES_PER_S, PEAK_OPS_PER_S, SLOPE_OPS,
the Riemann counts, velpred_ops, mkflux_update_ops, nbytes, bound), so that
a change there does not move the yardstick. A call's bytes are its inputs,
each read once, and its outputs, each written once; its operations are
counted by hand per interior cell from the kernels' function (every add,
sub, mul, div, min, max, abs, compare and select one; each intermediate
value once). Both depend only on the entry function's arguments and
results, whatever implements it.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: HBM3 rate and the peak rates outside the
# tensor cores, per dtype (dense)
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

SLOPE_OPS = {0: 0, 2: 18, 4: 28}  # Fromm slope 18, fourth-order step 10
RIEMANN_NORMAL, RIEMANN_TRANSVERSE = 9, 7


def velpred_ops(order):
    """max|u| (6); 9 slopes; per axis the hat states (two fractions 8,
    l/r of 3 components 12, one normal and two transverse solves); 6
    double-hat states (correction 4, l/r minus it 2, transverse solve);
    per face set the full state (two corrections 9, l/r minus them 2,
    force 3, normal solve)."""
    hat = 8 + 12 + RIEMANN_NORMAL + 2 * RIEMANN_TRANSVERSE
    return (6 + 9 * SLOPE_OPS[order] + 3 * hat
            + 6 * (4 + 2 + RIEMANN_TRANSVERSE)
            + 3 * (9 + 2 + 3 + RIEMANN_NORMAL))


def mkflux_update_ops(cons, force, fupd, order):
    """max|mac| (6); per component (cons[c]: conservative) 3 slopes, 3 hat
    states (l/r 10, transverse solve), 6 double-hat states (correction 3
    conservative or 4 convective, l/r minus it 2, transverse solve), 3 edge
    states (two corrections 15 or 9, l/r minus them 2, force 3, transverse
    solve) and the update (flux divergence 11 or u.grad s 17, dt and
    subtract 2, fupd 2)."""
    ops = 6
    for c in cons:
        ops += (3 * SLOPE_OPS[order] + 3 * (10 + RIEMANN_TRANSVERSE)
                + 6 * ((3 if c else 4) + 2 + RIEMANN_TRANSVERSE)
                + 3 * ((15 if c else 9) + 2 + (3 if force else 0)
                       + RIEMANN_TRANSVERSE)
                + (11 if c else 17) + 2 + (2 if fupd else 0))
    return ops


def nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound_s(bytes_moved, ops, dtype_name):
    """The least time of a call: the larger of its bytes at the memory
    rate and its operations at the peak rate, in seconds."""
    return max(bytes_moved / MEM_BYTES_PER_S,
               ops / PEAK_OPS_PER_S[dtype_name])


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [t for e in x for t in _flat(e)]
    return [x]


def velpred_call(a, out):
    """(bytes, operations) of velpred_3d_fused(u, force, dt, dx, phys_bc,
    adv_bc_vel, ng, n_cell, slope_order, ...) returning ``out``."""
    u, force, n_cell, order = a["u"], a["force"], a["n_cell"], a["slope_order"]
    return (nbytes([u, force] + _flat(out)),
            velpred_ops(order) * math.prod(n_cell))


def mkflux_update_call(a, out):
    """(bytes, operations) of mkflux_update_3d_fused(s, mac_pads, force,
    fupd, mac_rhs, ..., n_cell, is_vel, is_conservative, slope_order, ...)
    returning ``out`` (snew, or snew and the fluxes)."""
    s = a["s"]
    ins = [s, *a["mac_pads"], a["force"], a["mac_rhs"], a["fupd"]]
    cons = list(a["is_conservative"])[:s.shape[0]]
    ops = mkflux_update_ops(cons, a["force"] is not None,
                            a["fupd"] is not None, a["slope_order"])
    return nbytes(ins + _flat(out)), ops * math.prod(a["n_cell"])
