"""One multi-level step of the port against varden_tpu's (float64, CPU):
advance_ml.ml_advance on a 2-D bubble (16^2 base, one refined patch inside
the domain) and on the viscous 3-D bubble (16^3 base, one refined patch),
from the same seeded state, at 1e-9 of each field's size (the step's
composite solves stop at 1e-10 and 1e-12 of their right-hand sides; the
two packages run the same iterations). Also the step's inter-level
operators edge_restrict_mac, flux_sync and restrict_and_sync at 1e-12. The
varden_tpu step runs under jax.jit, once per file (module fixtures)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import smooth, state_arrays
from varden_tpu import problems as jprob
from varden_tpu.amr import advance_ml as jadv
from varden_tpu.amr import fill as jfill
from varden_tpu.amr import hierarchy as jh
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.state import Sim as JSim
from varden_tpu.state import State as JState
from varden_tpu_torch.amr import advance_ml as tadv
from varden_tpu_torch.amr import fill as tfill
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.ops import cuda_godunov as tcg
from varden_tpu_torch.state import Sim as TSim

WALLS = dict(bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15, bcz_lo=15,
             bcz_hi=15)
STEP_TOL = 1e-9
OP_TOL = 1e-12
# (dm, base n, fine patch (lo, n) in level-1 index space, config)
CASES = {
    "2d": (2, 16, ((8, 12), (16, 12)), dict(visc_coef=0.0, cflfac=0.9)),
    "3d-viscous": (3, 16, ((8, 8, 4), (16, 16, 16)),
                   dict(visc_coef=1.0e-3, cflfac=0.5)),
}


def _setup(case):
    dm, n, fine, over = CASES[case]
    kw = dict(dim_in=dm, prob_type=1, n_cellx=n, n_celly=n, n_cellz=n,
              max_levs=2, grav=-9.8, dtype="float64", **WALLS)
    kw.update(over)
    js, ts = JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")
    specs = [jh.domain_spec(js.n_cell, 0), jh.LevelSpec(*fine)]
    jg = jfill.MLGeom(js, specs)
    arrays = []
    for l, spec in enumerate(specs):
        st = jprob.initdata_on_spec(js, spec, l)
        a = state_arrays([st])[0]
        a["u"] = a["u"] + smooth(a["u"].shape, 20 + l, 0.3, dm=dm)
        a["gp"] = smooth(a["gp"].shape, 30 + l, 2.0, dm=dm)
        arrays.append(a)
    jst = [JState(**{k: jnp.asarray(v) for k, v in a.items()})
           for a in arrays]
    tg, tst = tfill.hierarchy_from_numpy(ts, [(s.lo, s.n) for s in specs],
                                         jg.parent, jg.depth, arrays)
    return js, ts, jg, tg, jst, tst


@pytest.fixture(scope="module", params=sorted(CASES))
def stepped(request):
    """Both packages' step from the same state: (case, port states and
    diag, varden_tpu states and diag, geometries)."""
    js, ts, jg, tg, jst, tst = _setup(request.param)
    dt = 0.5 * min(jg.dx(1)) / 0.5
    jout, jdiag = jax.jit(lambda st: jadv.ml_advance(jg, st, dt, 4))(jst)
    # the port's step with its Godunov wrappers counted: (name, flux_comps)
    # per call
    calls = []
    saved = {k: getattr(tcg, k) for k in ("mkflux_update_3d_fused",
                                           "mkflux_3d_fused")}

    def spy(name):
        def call(*a, **k):
            calls.append((name, tuple(k.get("flux_comps", ()))))
            return saved[name](*a, **k)
        return call

    for k in saved:
        setattr(tcg, k, spy(k))
    try:
        tout, tdiag = tadv.ml_advance(tg, tst, dt, 4)
    finally:
        for k, f in saved.items():
            setattr(tcg, k, f)
    return request.param, tout, tdiag, jout, jdiag, jg, tg, calls


def test_ml_advance_matches(stepped):
    case, tout, tdiag, jout, jdiag, jg, tg, _calls = stepped
    for a, b in zip(state_arrays(tout), state_arrays(jout)):
        for k in a:
            scale = max(1.0, float(np.abs(b[k]).max()))
            assert float(np.abs(a[k] - b[k]).max()) <= STEP_TOL * scale, k
    for k in ("div_before", "div_after"):
        assert abs(float(tdiag[k]) - float(jdiag[k])) <= \
            STEP_TOL * max(1.0, float(jdiag[k]))
    assert float(tdiag["div_after"]) < 1e-9 * float(tdiag["div_before"])
    assert float(tdiag["mac_ratio"]) <= 1.0 and float(tdiag["hg_ratio"]) <= 1.0
    assert tdiag["mac_outer"] > 0 and tdiag["hg_outer"] > 0
    if case == "3d-viscous":
        assert tdiag["visc_outer"] and tdiag["visc_ratio"] <= 1.0


def test_ml_advance_keeps_the_hierarchy_consistent(stepped):
    """Covered coarse cells hold the restriction of the fine ones."""
    _case, tout, _td, _jo, _jd, _jg, tg, _calls = stepped
    from varden_tpu_torch.amr.hierarchy import restrict_cells
    from varden_tpu_torch.amr.solve import covered_slice_rel
    cov = (slice(None),) + covered_slice_rel(tg, 1)
    for k in ("u", "s", "gp"):
        assert torch.allclose(getattr(tout[0], k)[cov],
                              restrict_cells(getattr(tout[1], k), tg.dm),
                              rtol=0.0, atol=1e-14)


def test_scalar_advance_takes_the_flux_option(stepped):
    """In 3-D each level's scalars advance in one fused pass that also
    emits density's conservative flux (flux_comps (0,)), as varden_tpu's
    accelerator path does, and the step still equals varden_tpu's
    (test_ml_advance_matches); the velocity takes the same kernel without
    fluxes, and the face kernel runs nowhere. In 2-D neither runs."""
    case, *_rest, calls = stepped
    if case == "2d":
        assert calls == []
        return
    assert calls.count(("mkflux_update_3d_fused", (0,))) == 2
    assert calls.count(("mkflux_update_3d_fused", ())) == 2
    assert len(calls) == 4


def _faces(rng, lead, n, dm):
    return tuple(rng.rand(*(lead + tuple(n[t] + (1 if t == d else 0)
                                         for t in range(dm))))
                 for d in range(dm))


def test_inter_level_operators_match():
    """edge_restrict_mac, flux_sync (a conservative and a convective
    component) and restrict_and_sync on a three-patch 2-D tree."""
    kw = dict(dim_in=2, prob_type=1, n_cellx=16, n_celly=16, max_levs=3,
              dtype="float64", **WALLS)
    js, ts = JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")
    specs = [((0, 0), (16, 16)), ((4, 4), (8, 8)), ((16, 20), (12, 8))]
    parent, depth = [-1, 0, 0], [0, 1, 1]
    jg = jfill.MLGeom(js, [jh.LevelSpec(*s) for s in specs], parent, depth)
    tg = tfill.MLGeom(ts, [tfill.LevelSpec(*s) for s in specs], parent,
                      depth)
    rng = np.random.RandomState(4)
    mac = [_faces(rng, (), s[1], 2) for s in specs]
    flux = [_faces(rng, (2,), s[1], 2) for s in specs]
    cells = [rng.rand(2, *s[1]) for s in specs]

    def ops(mod, tens):
        return (mod.edge_restrict_mac(jg if mod is jadv else tg,
                                      [tuple(tens(f) for f in m)
                                       for m in mac]),
                mod.flux_sync(jg if mod is jadv else tg,
                              [tuple(tens(f) for f in m) for m in flux],
                              [True, False]),
                mod.restrict_and_sync(jg if mod is jadv else tg,
                                      [tens(c) for c in cells]))

    want = jax.jit(lambda: ops(jadv, jnp.asarray))()
    got = ops(tadv, torch.tensor)
    flat_w = jax.tree_util.tree_leaves(want)
    flat_g = [x for grp in got for lev in grp
              for x in (lev if isinstance(lev, tuple) else (lev,))]
    assert len(flat_w) == len(flat_g)
    for g, w in zip(flat_g, flat_w):
        assert float(np.abs(g.numpy() - np.array(w)).max()) <= OP_TOL
