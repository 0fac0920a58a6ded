#!/usr/bin/env python3
"""Probe the composite nodal solve of the 3-D regression inputs at a 16^3
base with three levels (float64, CPU): the port against varden_tpu.

    JAX_PLATFORMS=cpu python3 tools/torch_amr_3level_probe.py

Level 1 of that hierarchy covers the domain with walls on every side, so
it fixes no node. The script prints, for that level's dense bottom operator
built with a mask of ones (as varden_tpu builds it), its condition number
and the largest entry of its inverse in numpy, jax and torch, and with the
port's regularisation (mask None) the same; then, on the port's step-1
solve inputs, the level residuals after each outer cycle of varden_tpu's
solve as it is, of varden_tpu's solve with the port's regularisation
patched in, and of the port; then the port's nodal outer cycles and max|u|
over four steps across the step-3 regrid. Takes a few minutes, most of it
varden_tpu's compiles.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)

from varden_tpu.amr import fill as jfill  # noqa: E402
from varden_tpu.amr import hierarchy as jh  # noqa: E402
from varden_tpu.amr import solve as jsolve  # noqa: E402
from varden_tpu.config import load_config as jload  # noqa: E402
from varden_tpu.solvers import nodal as jnodal  # noqa: E402
from varden_tpu.state import Sim as JSim  # noqa: E402
from varden_tpu_torch.amr import advance_ml as tadv  # noqa: E402
from varden_tpu_torch.amr import solve as tsolve  # noqa: E402
from varden_tpu_torch.config import load_config as tload  # noqa: E402
from varden_tpu_torch.driver import Varden as TVarden  # noqa: E402
from varden_tpu_torch.solvers import nodal as tnodal  # noqa: E402

PATH = os.path.join(ROOT, "inputs", "inputs_3d-regt")
OVER = dict(n_cellx=16, n_celly=16, n_cellz=16, max_levs=3,
            dtype="float64", plot_int=-1, chk_int=-1, verbose=0)


def fmt(norms):
    return " ".join(f"{x:.3e}" for x in norms)


def port_step1():
    """The port's step-1 nodal solve: its inputs and per-outer residuals."""
    calls = []
    solve, stop = tsolve.composite_nodal_solve, tsolve._stop_test

    def spied(geom, sigma_l, vel_l, **kw):
        hist = []

        def stop_test(*a):
            out = stop(*a)
            hist.append(out[0])
            return out

        tsolve._stop_test = stop_test
        out = solve(geom, sigma_l, vel_l, **kw)
        tsolve._stop_test = stop
        calls.append(dict(geom=geom, sigma=sigma_l, vel=vel_l, kw=kw,
                          hist=hist, info=out[1]))
        return out

    tadv.amr_solve.composite_nodal_solve = spied
    try:
        TVarden(tload(PATH, max_step=1, **OVER), device="cpu").run()
    finally:
        tadv.amr_solve.composite_nodal_solve = solve
    return calls[-1]


def bottom_operators(call):
    """Level 1's bottom operator with a mask of ones and regularised."""
    geom = call["geom"]
    n = list(geom.specs[1].n)
    sig = call["sigma"][1]
    ones = np.ones(tuple(s + 1 for s in n))
    pm = [False] * 3
    for tag, mask in (("mask of ones", ones), ("mask None", None)):
        lev = jnodal.build_hierarchy(n, list(geom.dx(1)), pm,
                                     jnp.asarray(sig.numpy()),
                                     None if mask is None
                                     else jnp.asarray(mask))[-1]
        A = np.asarray(jnodal._bottom_dense_A(lev))
        tl = tnodal.build_hierarchy(n, list(geom.dx(1)), pm, sig,
                                    None if mask is None
                                    else torch.as_tensor(mask))[-1]
        print(f"level 1 bottom {tuple(lev.n)}, {A.shape[0]} unknowns, "
              f"{tag}: condition {np.linalg.cond(A):.3e}; max|inverse| "
              f"numpy {np.abs(np.linalg.inv(A)).max():.3e}, jax "
              f"{float(jnp.abs(lev.binv).max()):.3e}, torch "
              f"{float(tl.binv.abs().max()):.3e}")


def reference_history(call, regularise):
    geom = call["geom"]
    js = JSim(jload(PATH, **OVER))
    jg = jfill.MLGeom(js, [jh.LevelSpec(tuple(s.lo), tuple(s.n))
                           for s in geom.specs], list(geom.parent),
                      list(geom.depth))
    masks = [js.nodal_mask()] + [jsolve.fine_nodal_mask(jg, lv)
                                 for lv in range(1, jg.nlev)]
    hist = []

    def norms(res):
        r0 = res[0] - jnp.mean(res[0]) if masks[0] is None else \
            res[0] * masks[0]
        return [float(jnp.max(jnp.abs(r0)))] + [
            float(jnp.max(jnp.abs(res[lv] * masks[lv])))
            for lv in range(1, jg.nlev)]

    def while_loop(cond, body, carry):
        step = jax.jit(body)
        hist.append(norms(carry[1]))
        while bool(cond(carry)):
            carry = step(carry)
            hist.append(norms(carry[1]))
        return carry

    build = jnodal.build_hierarchy

    def build_regularised(n, dx, pmask, sigma, mask):
        if mask is not None and bool(jnp.all(mask != 0)):
            mask = None
        return build(n, dx, pmask, sigma, mask)

    loop = jax.lax.while_loop
    jax.lax.while_loop = while_loop
    if regularise:
        jnodal.build_hierarchy = build_regularised
    try:
        A = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa
        kw = call["kw"]
        _phis, (_rn, outer, ratio) = jsolve.composite_nodal_solve(
            jg, [A(t) for t in call["sigma"]], [A(t) for t in call["vel"]],
            inflow_pad_l=[A(t) if torch.is_tensor(t) else None
                          for t in kw["inflow_pad_l"]],
            phi0_l=[A(t) for t in kw["phi0_l"]], rel_eps=kw["rel_eps"],
            return_info=True)
    finally:
        jax.lax.while_loop = loop
        jnodal.build_hierarchy = build
    return hist, int(outer), float(ratio)


def main():
    torch.set_num_threads(4)
    call = port_step1()
    bottom_operators(call)
    runs = [("varden_tpu", *reference_history(call, False)),
            ("varden_tpu regularised", *reference_history(call, True)),
            ("port", call["hist"], int(call["info"][1]),
             float(call["info"][2]))]
    for tag, hist, outer, ratio in runs:
        print(f"step-1 nodal solve, {tag}: {outer} outer cycles, ratio "
              f"{ratio:.3f}")
        for k, h in enumerate(hist):
            print(f"  outer {k}: level residuals {fmt(h)}")
    tsolve.TRACE = []
    v = TVarden(tload(PATH, max_step=4, **OVER), device="cpu")
    states = v.run()
    outers = [r["outer"] for r in tsolve.TRACE if r["kind"] == "nodal"]
    print(f"port, 4 steps: nodal outer cycles {outers} (initialization "
          f"first), levels {[tuple(s.n) for s in v.geom.specs]}, max|u| "
          f"{max(float(s.u.abs().max()) for s in states):.4f}")


if __name__ == "__main__":
    main()
