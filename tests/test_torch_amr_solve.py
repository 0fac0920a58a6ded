"""The port's composite (multi-level) solves against varden_tpu's
(float64, CPU), at 1e-9 of each solution's size: both run the same
composite V-cycle on the same levels with the same per-level smoothers (the
composite solves never take the single-level Helmholtz fast path, where the
two packages smooth differently on the CPU), so the solutions agree to far
below the solvers' stopping tolerance. The varden_tpu solves run under
jax.jit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_inputs import smooth, one_torch_thread  # noqa: F401
from varden_tpu.amr import fill as jfill
from varden_tpu.amr import hierarchy as jh
from varden_tpu.amr import solve as jsolve
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.state import Sim as JSim
from varden_tpu_torch.amr import fill as tfill
from varden_tpu_torch.amr import hierarchy as th
from varden_tpu_torch.amr import solve as tsolve
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.state import Sim as TSim

TOL = 1e-9
WALLS = dict(bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15, bcz_lo=15,
             bcz_hi=15)
# 2-D trees on a 16^2 base: a centred chain of three levels, and two
# sibling patches on one level
CHAIN3 = ([((0, 0), (16, 16)), ((8, 8), (16, 16)), ((24, 24), (16, 16))],
          [-1, 0, 1], [0, 1, 2])
SIBLINGS = ([((0, 0), (16, 16)), ((4, 4), (8, 8)), ((16, 20), (12, 8))],
            [-1, 0, 0], [0, 1, 1])
CHAIN2_3D = ([((0, 0, 0), (8, 8, 8)), ((4, 4, 2), (8, 8, 10))], [-1, 0],
             [0, 1])


def _geoms(tree, dm=2, **over):
    n = tree[0][0][1][0]
    kw = dict(dim_in=dm, prob_type=1, n_cellx=n, n_celly=n, n_cellz=n,
              max_levs=3, grav=-9.8, dtype="float64", **WALLS)
    kw.update(over)
    js, ts = JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")
    specs, parent, depth = tree
    return (jfill.MLGeom(js, [jh.LevelSpec(*s) for s in specs], parent,
                         depth),
            tfill.MLGeom(ts, [th.LevelSpec(*s) for s in specs], parent,
                         depth))


def _close_all(got, want):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.array(w)
        scale = max(1e-30, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= TOL * scale


def _fields(geom, lead, seed, amp, offset=0.0):
    dm = geom.dm
    return [smooth(lead + tuple(s.n), seed + i, amp, dm=dm) + offset
            for i, s in enumerate(geom.specs)]


def _mac_beta(geom, rho_l):
    """Face coefficients 2/(rho_i + rho_i-1) per level as the MAC
    projection forms them, from the density's ghost fill (pad_ml, held to
    varden_tpu's in test_torch_amr_hierarchy.py): periodic faces agree."""
    sim = geom.sim
    arrs = [torch.tensor(r) for r in rho_l]
    out = []
    for l in range(geom.nlev):
        p = tfill.pad_ml(geom, arrs, sim.scal_comp(0), l, 1).numpy()
        b = []
        for d in range(geom.dm):
            q = p
            for t in range(geom.dm):
                if t != d:
                    q = q.take(range(1, q.shape[t] - 1), t)
            b.append(2.0 / (q.take(range(1, q.shape[d]), d)
                            + q.take(range(0, q.shape[d] - 1), d)))
        out.append(b)
    return out


CC_CASES = {
    # (tree, config overrides, comp ('p' pressure / 'u' velocity), alpha)
    "p-walls-2lev": (SIBLINGS, {}, "p", 0.0),
    "u-dirichlet-3lev": (CHAIN3, {}, "u", 1.0),
    "p-periodic-3lev": (CHAIN3, dict(bcx_lo=-1, bcx_hi=-1, bcy_lo=-1,
                                     bcy_hi=-1), "p", 0.0),
}


@pytest.mark.parametrize("case", sorted(CC_CASES))
def test_composite_cc_solve_matches(case):
    tree, over, kind, alpha = CC_CASES[case]
    jg, tg = _geoms(tree, **over)
    sim = jg.sim
    comp = sim.press_comp if kind == "p" else 0
    rho = _fields(jg, (), 3, 0.4, 1.5)
    rhs = _fields(jg, (), 7, 5.0)
    if alpha == 0.0:
        beta = _mac_beta(tg, rho)
        aco = [np.zeros(s.n) for s in jg.specs]
    else:
        beta = [[0.01] * jg.dm] * jg.nlev
        aco = rho

    jb = [[b if np.isscalar(b) else jnp.asarray(b) for b in bl]
          for bl in beta]
    jphi, _ = jax.jit(lambda r, a, b: jsolve.composite_cc_solve(
        jg, comp, r, a, [tuple(x) for x in b], alpha, rel_eps=1e-10))(
            [jnp.asarray(r) for r in rhs], [jnp.asarray(a) for a in aco], jb)
    tb = [[b if np.isscalar(b) else torch.tensor(b) for b in bl]
          for bl in beta]
    tphi, (_rn, iters, ratio) = tsolve.composite_cc_solve(
        tg, comp, [torch.tensor(r) for r in rhs],
        [torch.tensor(a) for a in aco], tb, alpha, rel_eps=1e-10,
        return_info=True)
    assert 0 < iters < tsolve.MAX_OUTER and float(ratio) <= 1.0
    _close_all(tphi, jphi)


def test_composite_cc_solve_batched_bvals_matches():
    """The batched Helmholtz solve of the viscous step: the velocity
    components share the operator, their Dirichlet boundary values ride
    the batch axis (an inflow configuration: non-zero values on one
    side)."""
    jg, tg = _geoms(SIBLINGS, bcx_lo=11, bcx_hi=12,
                    u_bc=((0.7, 0.0), (0.0, 0.0), (0.0, 0.0)))
    dm, nlev = 2, jg.nlev
    rho = _fields(jg, (), 3, 0.4, 1.5)
    rhs = _fields(jg, (dm,), 9, 2.0)
    bv = [[[jg.sim.bvals[c][t][s] for c in range(dm)] for s in range(2)]
          for t in range(dm)]
    jbv = [[jnp.asarray(v).reshape((dm, 1, 1)) for v in p] for p in bv]
    tbv = [[torch.tensor(v, dtype=torch.float64).reshape((dm, 1, 1))
            for v in p] for p in bv]
    beta = (0.02,) * dm

    jphi, _ = jax.jit(lambda r, a, p0: jsolve.composite_cc_solve(
        jg, 0, r, a, [beta] * nlev, 1.0, phi0_l=p0, bvals=jbv,
        rel_eps=1e-12))([jnp.asarray(r) for r in rhs],
                        [jnp.asarray(a) for a in rho],
                        [jnp.asarray(r) for r in rhs])
    tphi, _ = tsolve.composite_cc_solve(
        tg, 0, [torch.tensor(r) for r in rhs], [torch.tensor(a) for a in rho],
        [beta] * nlev, 1.0, phi0_l=[torch.tensor(r) for r in rhs],
        bvals=tbv, rel_eps=1e-12)
    assert abs(float(np.array(bv).max()) - 0.7) < 1e-15
    _close_all(tphi, jphi)


def test_composite_cc_solve_3d_matches():
    """The MAC solve's shape in 3-D: face beta from a density, Neumann
    walls, two levels (the fine patch touches the domain's z walls)."""
    jg, tg = _geoms(CHAIN2_3D, dm=3)
    rho = _fields(jg, (), 3, 0.4, 1.5)
    rhs = _fields(jg, (), 5, 5.0)
    beta = _mac_beta(tg, rho)
    aco = [np.zeros(s.n) for s in jg.specs]
    comp = jg.sim.press_comp
    jphi, _ = jax.jit(lambda r, a, b: jsolve.composite_cc_solve(
        jg, comp, r, a, [tuple(x) for x in b], 0.0, rel_eps=1e-10))(
            [jnp.asarray(r) for r in rhs], [jnp.asarray(a) for a in aco],
            [[jnp.asarray(x) for x in b] for b in beta])
    tphi, _ = tsolve.composite_cc_solve(
        tg, comp, [torch.tensor(r) for r in rhs],
        [torch.tensor(a) for a in aco],
        [[torch.tensor(x) for x in b] for b in beta], 0.0, rel_eps=1e-10)
    _close_all(tphi, jphi)


@pytest.mark.parametrize("dm,tree", [(2, SIBLINGS), (3, CHAIN2_3D)],
                         ids=["2d-siblings", "3d"])
def test_composite_nodal_solve_matches(dm, tree):
    jg, tg = _geoms(tree, dm=dm)
    sigma = [1.0 / r for r in _fields(jg, (), 3, 0.4, 1.5)]
    vel = _fields(jg, (dm,), 13, 0.5)

    jphi, _ = jax.jit(lambda s, v: jsolve.composite_nodal_solve(
        jg, s, v, rel_eps=1e-10))([jnp.asarray(s) for s in sigma],
                                  [jnp.asarray(v) for v in vel])
    tphi, (_rn, iters, ratio) = tsolve.composite_nodal_solve(
        tg, [torch.tensor(s) for s in sigma], [torch.tensor(v) for v in vel],
        rel_eps=1e-10, return_info=True)
    assert 0 < iters < tsolve.MAX_OUTER and float(ratio) <= 1.0
    _close_all(tphi, jphi)
