"""The 3-D regression inputs (inputs/inputs_3d-regt) at a 16^3 base with
three levels, float64, CPU: 16^3, 32^3 over the whole domain and 48^3 at
(8, 8, 8). Level 1 covers the domain and, with walls on every side, fixes
no node of the composite nodal solve: its correction problem is singular
(the constants), as the base level's is. varden_tpu gives that level a
mask of ones, so its dense bottom operator is singular (condition ~1e17)
and its inverse is roundoff noise of order 1e15 that differs from library
to library; the two packages' residual histories part at the first outer
cycle, and varden_tpu's run blows up at step 2. The port regularises such a
level as it does a singular base level (mask None: the constants removed
at the bottom), on purpose (ROADMAP.md section 3).

Held here: varden_tpu's step 1 (ml_advance under jax.jit) from the port's
state and warm starts after its initialization equals the port's step 1
in every field of every patch to 1e-9 of its size (both solves converge,
to ratios that differ by more than half); on the step-1 solve's own
inputs, varden_tpu's composite nodal solve with the same regularisation
patched into it starts from the port's residuals and follows the port
outer cycle by outer cycle (1e-6 relative, or 1e-12 of the largest
starting residual for residuals near roundoff) and stops at the same count
with the same ratio. The port alone then runs four steps across the
step-3 regrid (level 2 becomes 64^3 over the domain) with every nodal
solve at or below its tolerance and max|u| below 1."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import state_arrays
from varden_tpu.amr import advance_ml as jadv
from varden_tpu.amr import fill as jfill
from varden_tpu.amr import hierarchy as jh
from varden_tpu.amr import solve as jsolve
from varden_tpu.config import load_config as jload
from varden_tpu.solvers import nodal as jnodal
from varden_tpu.state import Sim as JSim
from varden_tpu.state import State as JState
from varden_tpu_torch.amr import advance_ml as tadv
from varden_tpu_torch.amr import solve as tsolve
from varden_tpu_torch.config import load_config as tload
from varden_tpu_torch.driver import Varden as TVarden

PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "inputs", "inputs_3d-regt")
OVER = dict(n_cellx=16, n_celly=16, n_cellz=16, max_levs=3)


def _capture_last_nodal_solve(monkeypatch):
    """Record the inputs and the per-outer level residuals of every port
    composite nodal solve."""
    calls = []
    solve, stop = tsolve.composite_nodal_solve, tsolve._stop_test

    def spied(geom, sigma_l, vel_l, **kw):
        hist = []

        def stop_test(level_norms, tol, diag_max, phis):
            out = stop(level_norms, tol, diag_max, phis)
            hist.append(out[0])
            return out

        monkeypatch.setattr(tsolve, "_stop_test", stop_test)
        out = solve(geom, sigma_l, vel_l, **kw)
        monkeypatch.setattr(tsolve, "_stop_test", stop)
        calls.append(dict(geom=geom, sigma=sigma_l, vel=vel_l, kw=kw,
                          hist=hist, info=out[1]))
        return out

    monkeypatch.setattr(tadv.amr_solve, "composite_nodal_solve", spied)
    return calls


def _reference_history(call, monkeypatch):
    """varden_tpu's composite nodal solve on a port call's inputs, one
    jitted outer cycle at a time, with a fine level that fixes no node
    built with mask None as the port builds it: (per-outer level
    residuals, outer cycles, ratio)."""
    geom = call["geom"]
    js = JSim(jload(PATH, dtype="float64", **OVER))
    jg = jfill.MLGeom(js, [jh.LevelSpec(tuple(s.lo), tuple(s.n))
                           for s in geom.specs], list(geom.parent),
                      list(geom.depth))
    masks = [js.nodal_mask()] + [jsolve.fine_nodal_mask(jg, l)
                                 for l in range(1, jg.nlev)]
    hist = []

    def level_norms(res):
        r0 = res[0] - jnp.mean(res[0]) if masks[0] is None else \
            res[0] * masks[0]
        return [float(jnp.max(jnp.abs(r0)))] + [
            float(jnp.max(jnp.abs(res[l] * masks[l])))
            for l in range(1, jg.nlev)]

    def while_loop(cond, body, carry):
        step = jax.jit(body)
        hist.append(level_norms(carry[1]))
        while bool(cond(carry)):
            carry = step(carry)
            hist.append(level_norms(carry[1]))
        return carry

    build = jnodal.build_hierarchy

    def build_regularised(n, dx, pmask, sigma, mask):
        if mask is not None and bool(jnp.all(mask != 0)):
            mask = None
        return build(n, dx, pmask, sigma, mask)

    monkeypatch.setattr(jsolve.jax.lax, "while_loop", while_loop)
    monkeypatch.setattr(jsolve.nodal, "build_hierarchy", build_regularised)
    A = lambda t: None if t is None else jnp.asarray(t.numpy())  # noqa: E731
    kw = call["kw"]
    _phis, (_rn, outer, ratio) = jsolve.composite_nodal_solve(
        jg, [A(t) for t in call["sigma"]], [A(t) for t in call["vel"]],
        inflow_pad_l=[A(t) if torch.is_tensor(t) else None
                      for t in kw["inflow_pad_l"]],
        phi0_l=[A(t) for t in kw["phi0_l"]], rel_eps=kw["rel_eps"],
        return_info=True)
    monkeypatch.undo()
    return hist, int(outer), float(ratio)


def test_three_level_step_one_and_the_whole_domain_fine_level(monkeypatch):
    calls = _capture_last_nodal_solve(monkeypatch)
    steps = []
    advance = tadv.ml_advance

    def spied_advance(geom, states, dt, proj_type, hints=None):
        steps.append(dict(
            states=state_arrays(states), dt=float(dt), proj_type=proj_type,
            hints={k: [t.numpy().copy() for t in v]
                   for k, v in (hints or {}).items()}))
        return advance(geom, states, dt, proj_type, hints=hints)

    monkeypatch.setattr(tadv, "ml_advance", spied_advance)
    tv = TVarden(tload(PATH, dtype="float64", max_step=1, plot_int=-1,
                       chk_int=-1, verbose=0, **OVER), device="cpu")
    ts = tv.run()
    monkeypatch.undo()
    geom = tv.geom
    assert [tuple(s.n) for s in geom.specs] == \
        [(16, 16, 16), (32, 32, 32), (48, 48, 48)]
    step1 = calls[-1]
    port, port_outer = step1["hist"], int(step1["info"][1])
    port_ratio = float(step1["info"][2])
    assert port_outer == len(port) - 1 and port_ratio <= 1.0

    # varden_tpu's step 1 from the port's state and warm starts
    js = JSim(jload(PATH, dtype="float64", **OVER))
    jg = jfill.MLGeom(js, [jh.LevelSpec(tuple(s.lo), tuple(s.n))
                           for s in geom.specs], list(geom.parent),
                      list(geom.depth))
    first = steps[-1]
    jst = [JState(**{k: jnp.asarray(v) for k, v in a.items()})
           for a in first["states"]]
    hints = {k: [jnp.asarray(v) for v in vs]
             for k, vs in first["hints"].items()}
    jout, jdiag = jax.jit(lambda st, h: jadv.ml_advance(
        jg, st, first["dt"], first["proj_type"], hints=h))(jst, hints)
    for a, b in zip(state_arrays(ts), state_arrays(jout)):
        for k in a:
            scale = max(1.0, float(np.abs(b[k]).max()))
            assert float(np.abs(a[k] - b[k]).max()) <= 1e-9 * scale, k
    # both solves converge, varden_tpu's by another path
    ref_ratio = float(jdiag["hg_ratio"])
    assert ref_ratio <= 1.0 and abs(ref_ratio / port_ratio - 1.0) > 0.5

    reg, reg_outer, reg_ratio = _reference_history(step1, monkeypatch)
    np.testing.assert_allclose(reg[0], port[0], rtol=1e-9)
    assert reg_outer == port_outer
    # residuals near roundoff (level 2 ends near 1e-17) agree in absolute
    # terms: 1e-12 of the largest starting residual
    np.testing.assert_allclose(np.array(reg), np.array(port), rtol=1e-6,
                               atol=1e-12 * max(port[0]))
    assert abs(reg_ratio - port_ratio) <= 1e-6 * port_ratio


def test_three_level_run_converges_across_a_regrid():
    tsolve.TRACE = []
    try:
        v = TVarden(tload(PATH, dtype="float64", max_step=4, plot_int=-1,
                          chk_int=-1, verbose=0, **OVER), device="cpu")
        states = v.run()
        trace = [r for r in tsolve.TRACE if r["kind"] == "nodal"]
    finally:
        tsolve.TRACE = None
    assert v.istep == 4 and v.regrids >= 1
    assert [tuple(s.n) for s in v.geom.specs][-1] == (64, 64, 64)
    assert len(trace) >= 5
    for r in trace:
        assert max(r["level_res"]) <= max(r["tol"], r["floor"])
    assert float(v.last_diag["hg_ratio"]) <= 1.0
    assert max(float(s.u.abs().max()) for s in states) < 1.0
