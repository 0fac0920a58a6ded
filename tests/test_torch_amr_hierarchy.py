"""The port's AMR hierarchy, ghost fill, tagging and regridding against
varden_tpu's (float64, CPU).

Transfer operators, pad_ml / pad_ml_multi (walls, periodic, inlet),
tag_cells and build_level_data at 1e-12; cluster_tagged, compute_tree,
geom_covers, initialize_adaptive (2-D 32^2, 3-D 32^3) and initialize_fixed
on equal boxes, exactly (boxes are integers), with the initial states at
1e-12. The varden_tpu functions run under jax.jit: one compile is much
cheaper than their hundreds of eagerly dispatched small ops.

Last, the 3-D regression inputs with three levels (their section below
says what is held). They sit in this file, beside its many cheap tests,
because pytest-xdist's --dist loadfile hands the files out by their number
of tests, most first: a file of two heavy tests would start last and make
the run's tail."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import ref_jit, smooth, state_arrays, two_blob_rho
from varden_tpu import problems as jprob
from varden_tpu.amr import advance_ml as jadv
from varden_tpu.amr import fill as jfill
from varden_tpu.amr import hierarchy as jh
from varden_tpu.amr import regrid as jreg
from varden_tpu.amr import solve as jsolve
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.config import load_config as jload
from varden_tpu.solvers import nodal as jnodal
from varden_tpu.state import Sim as JSim
from varden_tpu.state import State as JState
from varden_tpu_torch import problems as tprob
from varden_tpu_torch.amr import advance_ml as tadv
from varden_tpu_torch.amr import fill as tfill
from varden_tpu_torch.amr import hierarchy as th
from varden_tpu_torch.amr import regrid as treg
from varden_tpu_torch.amr import solve as tsolve
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.config import load_config as tload
from varden_tpu_torch.driver import Varden as TVarden
from varden_tpu_torch.state import Sim as TSim

TOL = 1e-12


def _sims(**kw):
    base = dict(dim_in=2, prob_type=1, n_cellx=32, n_celly=32, n_cellz=32,
                max_levs=3, regrid_int=2, grav=-9.8, dtype="float64",
                bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15, bcz_lo=15,
                bcz_hi=15)
    base.update(kw)
    return JSim(JCfg(**base)), TSim(TCfg(**base), device="cpu")


def _close(a, b, tol=TOL):
    a, b = np.array(a), np.array(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert float(np.max(np.abs(a - b), initial=0.0)) <= tol * max(
        1.0, float(np.max(np.abs(a), initial=0.0)))


def _specs(geom):
    return [(tuple(s.lo), tuple(s.n)) for s in geom.specs]


@pytest.mark.parametrize("dm", [2, 3])
def test_transfer_operators_match(dm):
    rng = np.random.RandomState(dm)
    c = rng.rand(2, *([6] * dm)) - 0.3
    lo, flo, fn = (1,) * dm, (4,) * dm, (6,) * dm

    def ops(h, x):
        return ([h.restrict_faces(x, d, dm) for d in range(dm)]
                + [h.restrict_cells(x, dm), h.prolong_cells(x, dm),
                   h.prolong_cells(x, dm, limit=False),
                   h.prolong_cells(x, dm, order=0), h.prolong_nodes(x, dm),
                   h.interp_patch(x, lo, flo, fn, dm)])

    want = ref_jit(lambda x: ops(jh, x))(jnp.asarray(c))
    for got, w in zip(ops(th, torch.tensor(c)), want):
        _close(got, w)


# (bc overrides, patch tree) for pad_ml: walls with a centred chain of three
# levels and two sibling patches; periodic x with a full-span patch; an
# inlet side touched by the fine patch
PAD_CASES = {
    "walls-chain": (dict(), [((0, 0), (32, 32)), ((16, 16), (32, 24)),
                             ((40, 40), (16, 16))], [-1, 0, 1], [0, 1, 2]),
    "walls-siblings": (dict(), [((0, 0), (32, 32)), ((8, 8), (16, 16)),
                                ((40, 32), (16, 24))], [-1, 0, 0], [0, 1, 1]),
    "periodic-x": (dict(bcx_lo=-1, bcx_hi=-1), [((0, 0), (32, 32)),
                                                 ((0, 16), (64, 24))],
                   [-1, 0], [0, 1]),
    "inlet": (dict(bcx_lo=11, bcx_hi=12, bcy_lo=14, bcy_hi=14,
                   u_bc=((0.7, 0.0), (0.0, 0.0), (0.0, 0.0)),
                   rho_bc=((1.3, 0.0), (0.0, 0.0), (0.0, 0.0))),
              [((0, 0), (32, 32)), ((0, 8), (24, 40))], [-1, 0], [0, 1]),
}


@pytest.mark.parametrize("case", sorted(PAD_CASES))
def test_pad_ml_matches(case):
    over, specs, parent, depth = PAD_CASES[case]
    js, ts = _sims(**over)
    jg = jfill.MLGeom(js, [jh.LevelSpec(*s) for s in specs], parent, depth)
    tg = tfill.MLGeom(ts, [th.LevelSpec(*s) for s in specs], parent, depth)
    arrs = [smooth((2,) + s[1], 10 + i, 1.0, dm=2) + 1.5
            for i, s in enumerate(specs)]
    comp = js.scal_comp(0)

    @ref_jit
    def jpads(ja):
        return ([jfill.pad_ml_multi(jg, ja, [0, 1], lev, 3)
                 for lev in range(len(specs))],
                [jfill.pad_ml(jg, [a[0] for a in ja], comp, lev, 1)
                 for lev in range(len(specs))])

    want_multi, want_one = jpads([jnp.asarray(a) for a in arrs])
    for lev in range(len(specs)):
        assert jg.phys_bc_level(lev) == tg.phys_bc_level(lev)
        assert jg.ell_bc_level(lev, 0) == tg.ell_bc_level(lev, 0)
        _close(tfill.pad_ml_multi(tg, [torch.tensor(a) for a in arrs],
                                  [0, 1], lev, 3), want_multi[lev])
        _close(tfill.pad_ml(tg, [torch.tensor(a[0]) for a in arrs], comp,
                            lev, 1), want_one[lev])


def test_tag_cells_and_cluster_tagged_match():
    for pt in (1, 3):
        js, ts = _sims(prob_type=pt)
        rho = 1.0 + smooth((32, 32), pt, 1.0, dm=2) ** 2
        for lev in range(3):
            a = np.array(jprob.tag_cells(js, jnp.asarray(rho), lev))
            assert np.array_equal(
                tprob.tag_cells(ts, torch.tensor(rho), lev).numpy(), a)
    rng = np.random.RandomState(3)
    for shape, p in (((40, 40), 0.05), ((24, 24, 24), 0.02)):
        tags = rng.rand(*shape) < p
        tags[5:12, 6:14] = True
        for kw in (dict(), dict(min_eff=0.9, blocking=2, min_width=2)):
            assert treg.cluster_tagged(tags, **kw) == \
                jreg.cluster_tagged(tags, **kw)


def _blob_states(js, ts, centers):
    rho = two_blob_rho(js.n_cell, js.dx, centers)
    n = js.n_cell
    z = np.zeros((2,) + tuple(n))
    s = np.stack([rho, np.zeros(n)])
    p = np.zeros(tuple(v + 1 for v in n))
    jst = JState(u=jnp.asarray(z), s=jnp.asarray(s), gp=jnp.asarray(z),
                 p=jnp.asarray(p))
    return jst, tfill.hierarchy_from_numpy(
        ts, [((0, 0), n)], [-1], [0],
        [dict(u=z, s=s, gp=z, p=p)])[1][0]


@pytest.mark.parametrize("centers,slack,patches", [
    ([(0.2, 0.2), (0.8, 0.8)], 0, 2), ([(0.42, 0.5), (0.58, 0.5)], 0, 1),
    ([(0.2, 0.2), (0.8, 0.8)], 8, 1)], ids=["two-patches", "merged", "slack"])
def test_compute_tree_and_geom_covers_match(centers, slack, patches):
    js, ts = _sims(n_cellx=64, n_celly=64, max_levs=2, regrid_slack=slack)
    jst, tst = _blob_states(js, ts, centers)
    jg = jfill.MLGeom(js, [jh.domain_spec(js.n_cell, 0)])
    tg = tfill.MLGeom(ts, [th.domain_spec(ts.n_cell, 0)])
    jt = jreg.compute_tree(js, jg, [jst])
    tt = treg.compute_tree(ts, tg, [tst])
    assert [(s.lo, s.n) for s in tt[0]] == [(s.lo, s.n) for s in jt[0]]
    assert tt[1:] == jt[1:]
    assert tt[2].count(1) == patches
    # the new tree covers itself; a tree without its patches does not
    jg2 = jfill.MLGeom(js, *jt)
    tg2 = tfill.MLGeom(ts, [th.LevelSpec(s.lo, s.n) for s in tt[0]],
                       tt[1], tt[2])
    for waste in (1.0, 2.0):
        assert treg.geom_covers(tg2, *tt, waste) == \
            jreg.geom_covers(jg2, *jt, waste)
        assert treg.geom_covers(tg, *tt, waste) == \
            jreg.geom_covers(jg, *jt, waste)


@pytest.mark.parametrize("dm", [2, 3])
def test_initialize_adaptive_matches(dm):
    """The bubble's hierarchy at 32^dm base, three levels: the same boxes
    and the same initial data on every patch; then build_level_data onto a
    shifted tree."""
    js, ts = _sims(dim_in=dm)
    jg, jst = jreg.initialize_adaptive(js)
    tg, tst = treg.initialize_adaptive(ts)
    assert _specs(tg) == _specs(jg)
    assert tg.parent == jg.parent and tg.depth == jg.depth
    assert tg.ndepth == 3
    for a, b in zip(state_arrays(tst), state_arrays(jst)):
        for k in a:
            _close(a[k], b[k])
    # move the data onto a tree whose finest patch is shifted by 8 cells
    specs = [(s.lo, s.n) for s in jg.specs]
    lo, n = specs[-1]
    specs[-1] = (tuple(v + 8 for v in lo), tuple(v - 8 for v in n))
    jnew = jfill.MLGeom(js, [jh.LevelSpec(*s) for s in specs], jg.parent,
                        jg.depth)
    tnew = tfill.MLGeom(ts, [th.LevelSpec(*s) for s in specs], tg.parent,
                        tg.depth)
    moved = ref_jit(lambda st: jreg.build_level_data(js, jg, st, jnew))(jst)
    for a, b in zip(state_arrays(treg.build_level_data(ts, tg, tst, tnew)),
                    state_arrays(moved)):
        for k in a:
            _close(a[k], b[k])


def test_initialize_fixed_and_write_grids_match(tmp_path):
    grids = tmp_path / "grids_2box"
    grids.write_text("3\n2\n((8,8) (39,39) (0,0))\n((86,88) (119,119) "
                     "(0,0))\n((24,24) (63,55) (0,0))\n")
    js, ts = _sims(n_cellx=64, n_celly=64, fixed_grids=str(grids))
    jg, jst = jreg.initialize_fixed(js)
    tg, tst = treg.initialize_fixed(ts)
    assert _specs(tg) == _specs(jg)
    assert tg.parent == jg.parent and tg.depth == jg.depth
    assert tg.depth.count(1) == 2
    for a, b in zip(state_arrays(tst), state_arrays(jst)):
        for k in a:
            _close(a[k], b[k])
    treg.write_grids(str(tmp_path / "t.log"), tg, 0)
    jreg.write_grids(str(tmp_path / "j.log"), jg, 0)
    assert (tmp_path / "t.log").read_text() == (tmp_path / "j.log").read_text()


# The 3-D regression inputs (inputs/inputs_3d-regt) at a 16^3 base with three
# levels, float64, CPU: 16^3, 32^3 over the whole domain and 48^3 at (8, 8, 8).
# Level 1 covers the domain and, with walls on every side, fixes no node of the
# composite nodal solve: its correction problem is singular (the constants), as
# the base level's is. varden_tpu gives that level a mask of ones, so its dense
# bottom operator is singular (condition ~1e17) and its inverse is roundoff
# noise of order 1e15 that differs from library to library; the two packages'
# residual histories part at the first outer cycle, and varden_tpu's run blows
# up at step 2. The port regularises such a level as it does a singular base
# level (mask None: the constants removed at the bottom), on purpose
# (ROADMAP.md section 3).
#
# Held here: varden_tpu's step 1 (ml_advance under jax.jit) from the port's
# state and warm starts after its initialization equals the port's step 1 in
# every field of every patch to 1e-9 of its size (both solves converge, to
# ratios that differ by more than half); on the step-1 solve's own inputs,
# varden_tpu's composite nodal solve with the same regularisation patched into
# it starts from the port's residuals and follows the port outer cycle by outer
# cycle (1e-6 relative, or 1e-12 of the largest starting residual for residuals
# near roundoff) and stops at the same count with the same ratio. The port
# alone then runs four steps across the step-3 regrid (level 2 becomes 64^3
# over the domain) with every nodal solve at or below its tolerance and max|u|
# below 1.
REGT_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "inputs", "inputs_3d-regt")
REGT_OVER = dict(n_cellx=16, n_celly=16, n_cellz=16, max_levs=3)


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
    js = JSim(jload(REGT_PATH, dtype="float64", **REGT_OVER))
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
    tv = TVarden(tload(REGT_PATH, dtype="float64", max_step=1, plot_int=-1,
                       chk_int=-1, verbose=0, **REGT_OVER), device="cpu")
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
    js = JSim(jload(REGT_PATH, dtype="float64", **REGT_OVER))
    jg = jfill.MLGeom(js, [jh.LevelSpec(tuple(s.lo), tuple(s.n))
                           for s in geom.specs], list(geom.parent),
                      list(geom.depth))
    first = steps[-1]
    jst = [JState(**{k: jnp.asarray(v) for k, v in a.items()})
           for a in first["states"]]
    hints = {k: [jnp.asarray(v) for v in vs]
             for k, vs in first["hints"].items()}
    jout, jdiag = ref_jit(lambda st, h: jadv.ml_advance(
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
        v = TVarden(tload(REGT_PATH, dtype="float64", max_step=4,
                          plot_int=-1, chk_int=-1, verbose=0, **REGT_OVER),
                    device="cpu")
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
