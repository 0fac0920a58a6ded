"""The port's AMR hierarchy, ghost fill, tagging and regridding against
varden_tpu's (float64, CPU).

Transfer operators, pad_ml / pad_ml_multi (walls, periodic, inlet),
tag_cells and build_level_data at 1e-12; cluster_tagged, compute_tree,
geom_covers, initialize_adaptive (2-D 32^2, 3-D 32^3) and initialize_fixed
on equal boxes, exactly (boxes are integers), with the initial states at
1e-12. The varden_tpu functions run under jax.jit: one compile is much
cheaper than their hundreds of eagerly dispatched small ops."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import smooth, state_arrays, two_blob_rho
from varden_tpu import problems as jprob
from varden_tpu.amr import fill as jfill
from varden_tpu.amr import hierarchy as jh
from varden_tpu.amr import regrid as jreg
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.state import Sim as JSim
from varden_tpu.state import State as JState
from varden_tpu_torch import problems as tprob
from varden_tpu_torch.amr import fill as tfill
from varden_tpu_torch.amr import hierarchy as th
from varden_tpu_torch.amr import regrid as treg
from varden_tpu_torch.config import VardenConfig as TCfg
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

    want = jax.jit(lambda x: ops(jh, x))(jnp.asarray(c))
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

    @jax.jit
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
    moved = jax.jit(lambda st: jreg.build_level_data(js, jg, st, jnew))(jst)
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
