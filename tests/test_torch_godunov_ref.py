"""The port's Godunov debug oracle (varden_tpu_torch.ops.godunov_ref, the
full-array roll form that use_godunov_debug selects) against varden_tpu's
(varden_tpu.ops.godunov_ref) on the same numpy-made inputs, float64, CPU:
velpred and mkflux in 2-D at 16^2 and 3-D at 8^3, over the boundary sets
of tests/test_godunov_equiv.py (periodic; no-slip walls; inlet/outlet in
x, slip walls in y, symmetry in z), scalars and velocity, use_minion with
force and mac_rhs both ways. Tolerance 1e-13 absolute on O(1) fields, the
reference's own test tolerance: the two run the same formulas op for op.
Then the oracle with a given ``umax`` against the port's windowed path
with the tie epsilon of that umax, and with force and mac_rhs absent
against zero tensors. Last, whole runs with use_godunov_debug in 2-D at
16^2 and 3-D at 8^3 against varden_tpu's with the same flag, every field
within 1e-10 of its size."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import assert_runs_agree, ref_jit, run_inputs_both

from varden_tpu.advance import embed_faces as jembed
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.ops import godunov_ref as jref
from varden_tpu.ops import slopes as jsl
from varden_tpu.state import Sim as JSim
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.ops import godunov as tg2
from varden_tpu_torch.ops import godunov3d as tg3
from varden_tpu_torch.ops import godunov_ref as tref
from varden_tpu_torch.ops import slopes as tsl
from varden_tpu_torch.state import Sim as TSim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-13
BCS = {
    "periodic": [-1] * 6,
    "noslip": [15] * 6,
    "mixed": [11, 12, 14, 14, 13, 13],
}
N = {2: 16, 3: 8}
DT = 0.01


def _sims(dm, bc):
    n = N[dm]
    kw = dict(dim_in=dm, prob_type=1, n_cellx=n, n_celly=n, bcx_lo=bc[0],
              bcx_hi=bc[1], bcy_lo=bc[2], bcy_hi=bc[3], grav=-9.8,
              dtype="float64", u_bc=((0.7, 0.0), (0.0, 0.0), (0.0, 0.0)),
              rho_bc=((1.3, 0.0), (0.0, 0.0), (0.0, 0.0)))
    if dm == 3:
        kw.update(n_cellz=n, bcz_lo=bc[4], bcz_hi=bc[5])
    return JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")


def _close(t, j, what, tol=TOL):
    err = float(np.max(np.abs(t.numpy() - np.asarray(j))))
    assert err < tol, f"{what}: {err}"


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("order", [0, 2, 4])
@pytest.mark.parametrize("bcs", [(1, 3), (3, 2), (2, 1), (0, 0)])
def test_slope_ref_matches(order, bcs):
    rng = np.random.RandomState(order + 10)
    s = rng.randn(14, 9, 11)
    for axis in (0, 2):
        ref = jsl.slope_ref(jnp.asarray(s), axis, 3, bcs[0], bcs[1], order,
                            s.shape[axis] - 6)
        out = tsl.slope_ref(torch.as_tensor(s), axis, 3, bcs[0], bcs[1],
                            order, s.shape[axis] - 6)
        # every plane the one-sided stencils write, and the interior
        sl = [slice(None)] * 3
        sl[axis] = slice(2, s.shape[axis] - 2)
        _close(out[tuple(sl)], np.asarray(ref)[tuple(sl)],
               f"slope_ref order={order} axis={axis}")


@pytest.mark.parametrize("dm", [2, 3])
@pytest.mark.parametrize("bcname", list(BCS))
def test_velpred_ref_matches(dm, bcname):
    js, ts = _sims(dm, BCS[bcname])
    n, ng = js.n_cell, js.ng
    rng = np.random.RandomState(7)
    shape = (dm,) + tuple(s + 2 * ng for s in n)
    u, f = rng.randn(*shape), 0.1 * rng.randn(*shape)
    adv = [js.adv_bc[d] for d in range(dm)]
    for minion in (False, True):
        args = (DT, js.dx, js.phys_bc, adv, ng, n, 4, minion)
        fn = jref.velpred_2d if dm == 2 else jref.velpred_3d
        tfn = tref.velpred_2d if dm == 2 else tref.velpred_3d
        ref = ref_jit(lambda u, f: fn(u, f, *args))(jnp.asarray(u),
                                                    jnp.asarray(f))
        out = tfn(_t(u), _t(f), *args)
        for d in range(dm):
            assert out[d].shape == ref[d].shape
            _close(out[d], ref[d], f"velpred dm={dm} {bcname} face {d}")


_EMBED = {}


def _embed(js):
    """varden_tpu's embed_faces on the configuration of ``js``, jitted once
    for each configuration (the faces are its argument)."""
    key = repr(js.cfg)
    if key not in _EMBED:
        _EMBED[key] = ref_jit(lambda um: jembed(js, um, js.ng))
    return _EMBED[key]


def _mkflux_inputs(js, dm, is_vel, seed=3):
    n, ng = js.n_cell, js.ng
    rng = np.random.RandomState(seed)
    nc = dm if is_vel else 2
    sshape = (nc,) + tuple(s + 2 * ng for s in n)
    s = rng.randn(*sshape) + 2.0
    sf = rng.randn(*sshape) * 0.1
    mrhs = rng.randn(*[x + 2 * ng for x in n]) * 0.1
    umac = tuple(rng.randn(*[n[t] + (1 if t == d else 0) for t in range(dm)])
                 for d in range(dm))
    mp = _embed(js)(tuple(jnp.asarray(x) for x in umac))
    adv = ([js.adv_bc[d] for d in range(dm)] if is_vel
           else [js.adv_bc[js.scal_comp(i)] for i in range(2)])
    cons = [False] * dm if is_vel else [True, False]
    return s, sf, mrhs, [np.asarray(m) for m in mp], adv, cons


@pytest.mark.parametrize("dm", [2, 3])
@pytest.mark.parametrize("bcname", list(BCS))
@pytest.mark.parametrize("is_vel", [False, True])
def test_mkflux_ref_matches(dm, bcname, is_vel):
    js, _ts = _sims(dm, BCS[bcname])
    n, ng = js.n_cell, js.ng
    s, sf, mrhs, mp, adv, cons = _mkflux_inputs(js, dm, is_vel)
    minion = not is_vel  # the minion source branch once
    tail = (DT, js.dx, js.phys_bc, adv, ng, n, is_vel, cons, 4, minion)
    if dm == 2:
        ref = ref_jit(lambda s, f, r, m0, m1: jref.mkflux_2d(
            s, m0, m1, f, r, *tail))(*map(jnp.asarray, (s, sf, mrhs, *mp)))
        out = tref.mkflux_2d(_t(s), _t(mp[0]), _t(mp[1]), _t(sf), _t(mrhs),
                             *tail)
    else:
        ref = ref_jit(lambda s, f, r, m: jref.mkflux_3d(
            s, m, f, r, *tail))(jnp.asarray(s), jnp.asarray(sf),
                                jnp.asarray(mrhs),
                                tuple(map(jnp.asarray, mp)))
        ref = (*ref[0], *ref[1])
        out = tref.mkflux_3d(_t(s), [_t(m) for m in mp], _t(sf), _t(mrhs),
                             *tail)
        out = (*out[0], *out[1])
    assert len(out) == len(ref) == 2 * dm
    for k, (o, r) in enumerate(zip(out, ref)):
        assert o.shape == r.shape
        _close(o, r, f"mkflux dm={dm} {bcname} vel={is_vel} output {k}")


@pytest.mark.parametrize("dm", [2, 3])
@pytest.mark.parametrize("bcname", ["noslip", "mixed"])
def test_oracle_umax_and_absent_sources(dm, bcname):
    """With the level's umax the oracle forms its tie epsilon from it, as
    the windowed path does from the eps it is given; force and mac_rhs
    absent equal zero tensors."""
    js, ts = _sims(dm, BCS[bcname])
    n, ng = ts.n_cell, ts.ng
    umax = torch.tensor(3.5, dtype=torch.float64)
    eps = tg2._eps_from(umax)
    for is_vel in (False, True):
        s, sf, mrhs, mp, adv, cons = _mkflux_inputs(js, dm, is_vel, seed=5)
        mp = [_t(m) for m in mp]
        tail = (DT, ts.dx, ts.phys_bc, adv, ng, n, is_vel, cons, 4, False)
        zero_f, zero_r = torch.zeros(s.shape, dtype=torch.float64), \
            torch.zeros(mrhs.shape, dtype=torch.float64)
        if dm == 2:
            ref = tg2.mkflux_2d(_t(s), *mp, _t(sf), None, *tail, eps=eps)
            out = tref.mkflux_2d(_t(s), *mp, _t(sf), None, *tail, umax=umax)
            absent = tref.mkflux_2d(_t(s), *mp, None, None, *tail)
            zeros = tref.mkflux_2d(_t(s), *mp, zero_f, zero_r, *tail)
        else:
            ref = tg3.mkflux_3d(_t(s), mp, _t(sf), None, *tail, eps=eps)
            out = tref.mkflux_3d(_t(s), mp, _t(sf), None, *tail, umax=umax)
            absent = tref.mkflux_3d(_t(s), mp, None, None, *tail)
            zeros = tref.mkflux_3d(_t(s), mp, zero_f, zero_r, *tail)
            ref, out = (*ref[0], *ref[1]), (*out[0], *out[1])
            absent, zeros = (*absent[0], *absent[1]), (*zeros[0], *zeros[1])
        for k in range(len(ref)):
            _close(out[k], ref[k].numpy(), f"umax dm={dm} output {k}")
            _close(absent[k], zeros[k].numpy(), f"absent dm={dm} output {k}")
    u = np.random.RandomState(9).randn(dm, *[x + 2 * ng for x in n])
    adv = [ts.adv_bc[d] for d in range(dm)]
    args = (DT, ts.dx, ts.phys_bc, adv, ng, n, 4, False)
    if dm == 2:
        ref = tg2.velpred_2d(_t(u), _t(0.1 * u), *args, eps=eps)
        out = tref.velpred_2d(_t(u), _t(0.1 * u), *args, umax=umax)
    else:
        ref = tg3.velpred_3d(_t(u), _t(0.1 * u), *args, eps=eps)
        out = tref.velpred_3d(_t(u), _t(0.1 * u), *args, umax=umax)
    for d in range(dm):
        _close(out[d], ref[d].numpy(), f"velpred umax dm={dm} face {d}")


@pytest.mark.parametrize("name,over", [
    ("inputs_bubble_2d", dict(max_levs=1, n_cellx=16, n_celly=16)),
    ("inputs_bubble_3d", dict(max_levs=1, n_cellx=8, n_celly=8, n_cellz=8))])
def test_debug_run_matches_varden_tpu(name, over):
    """Varden.run with use_godunov_debug for two steps in both packages:
    every field within 1e-10 of its size."""
    runs = run_inputs_both(os.path.join(ROOT, "inputs", name), max_step=2,
                           use_godunov_debug=True, **over)
    assert runs[1].istep == 2 and runs[1].cfg.use_godunov_debug
    assert_runs_agree(*runs, tol=1e-10)
