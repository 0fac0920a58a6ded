"""The port's 2-D Godunov path against varden_tpu's on the same inputs
(float64, CPU): limited slopes on 2-D tensors, velpred_2d and mkflux_2d
(scalars conservative + convective, velocity; with and without forces and a
divu source), each against varden_tpu.ops.godunov and against the whole-grid
Pallas kernels in interpret mode, for walls, periodic, slip/outflow and
inlet/outlet boundaries. The kernel wrappers take their plain versions on
CPU tensors. Tolerance 1e-12 absolute on O(1) fields: the formulas are the
same op for op, so only library-level roundoff differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_inputs import smooth

from varden_tpu.advance import embed_faces as jembed
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.ops import godunov as jg
from varden_tpu.ops import pallas_godunov as jpg
from varden_tpu.ops import slopes as jsl
from varden_tpu.state import Sim as JSim
from varden_tpu_torch.advance import embed_faces as tembed
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.ops import cuda_godunov as tcg
from varden_tpu_torch.ops import godunov as tg
from varden_tpu_torch.ops import slopes as tsl
from varden_tpu_torch.state import Sim as TSim

TOL = 1e-12
N = (24, 32)
# (x lo, x hi, y lo, y hi): walls; periodic; periodic x with slip walls;
# inlet/outlet in x with slip walls (inputs_advect_2d); outlet top, symmetry
BCS = [(15, 15, 15, 15), (-1, -1, -1, -1), (-1, -1, 14, 14),
       (11, 12, 14, 14), (13, 13, 15, 12)]


def _sims(bc, n=N, **extra):
    kw = dict(dim_in=2, prob_type=1, n_cellx=n[0], n_celly=n[1],
              prob_hi_y=n[1] / n[0], bcx_lo=bc[0], bcx_hi=bc[1], bcy_lo=bc[2],
              bcy_hi=bc[3], grav=-9.8, dtype="float64",
              u_bc=((0.7, 0.0), (0.0, 0.0), (0.0, 0.0)),
              rho_bc=((1.3, 0.0), (0.0, 0.0), (0.0, 0.0)), **extra)
    return JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")


def _close(t, j, what):
    err = float(np.max(np.abs(t.numpy() - np.asarray(j))))
    assert err < TOL, f"{what}: {err}"


@pytest.mark.parametrize("order", [0, 2, 4])
@pytest.mark.parametrize("bcs", [(1, 3), (3, 2), (2, 1), (0, 0)])
def test_slope_2d_matches(order, bcs):
    rng = np.random.RandomState(order)
    s = rng.randn(22, 13)
    for axis in (0, 1):
        w = jsl.slope(jnp.asarray(s), axis, 3, bcs[0], bcs[1], order,
                      s.shape[axis] - 6, dm=2)
        out = tsl.slope(torch.as_tensor(s), axis, 3, bcs[0], bcs[1], order,
                        s.shape[axis] - 6)
        sl = tuple(slice(w.lo[d], w.hi[d]) for d in range(2))
        _close(out[sl], w.arr, f"slope order={order} axis={axis}")


def _vel_inputs(js, seed=7):
    n, ng = js.n_cell, js.ng
    u = smooth((2,) + n, seed, dm=2)
    f = smooth((2,) + n, seed + 1, amp=0.3, dm=2)
    u_pad = np.array(js.fill_vel(jnp.asarray(u)))
    f_pad = np.array(js.fill_extrap(jnp.asarray(f), ng))
    return u_pad, f_pad


@pytest.mark.parametrize("use_minion", [False, True])
@pytest.mark.parametrize("bc", BCS)
def test_velpred_2d_matches(bc, use_minion):
    js, ts = _sims(bc)
    u_pad, f_pad = _vel_inputs(js)
    adv = [js.adv_bc[d] for d in range(2)]
    args = (2e-3, js.dx, js.phys_bc, adv, js.ng, js.n_cell, 4, use_minion)
    ju, jf = jnp.asarray(u_pad), jnp.asarray(f_pad)
    ref = jg.velpred_2d(ju, jf, *args)
    ker = jpg.velpred_2d_fused(ju, jf, *args, interpret=True)
    tu, tf = torch.as_tensor(u_pad), torch.as_tensor(f_pad)
    out = tg.velpred_2d(tu, tf, *args)
    fused = tcg.velpred_2d_fused(tu, tf, *args)
    for d in range(2):
        assert out[d].shape == ref[d].shape
        _close(out[d], ref[d], f"velpred_2d bc={bc} face {d}")
        _close(out[d], ker[d], f"velpred_2d vs pallas bc={bc} face {d}")
        assert torch.equal(fused[d], out[d])


@pytest.mark.parametrize("order", [0, 2])
def test_velpred_2d_slope_orders(order):
    js, ts = _sims(BCS[3])
    u_pad, f_pad = _vel_inputs(js, 3)
    adv = [js.adv_bc[d] for d in range(2)]
    args = (2e-3, js.dx, js.phys_bc, adv, js.ng, js.n_cell, order, False)
    ref = jg.velpred_2d(jnp.asarray(u_pad), jnp.asarray(f_pad), *args)
    out = tg.velpred_2d(torch.as_tensor(u_pad), torch.as_tensor(f_pad), *args)
    for d in range(2):
        _close(out[d], ref[d], f"velpred_2d order={order} face {d}")


def _mkflux_case(js, ts, is_vel, seed=11):
    """(jax args, torch args) of one mkflux_2d call on MAC faces that the
    packages' own embed_faces pad."""
    n, ng = js.n_cell, js.ng
    umac = [smooth((n[0] + 1, n[1]), seed, dm=2),
            smooth((n[0], n[1] + 1), seed + 1, dm=2)]
    jm = jembed(js, tuple(jnp.asarray(m) for m in umac), ng)
    tm = tembed(ts, tuple(torch.as_tensor(m) for m in umac), ng)
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b.numpy(), np.array(a))
    if is_vel:
        s = smooth((2,) + n, seed + 2, dm=2)
        s_pad = np.array(js.fill_vel(jnp.asarray(s)))
        adv = [js.adv_bc[d] for d in range(2)]
        cons = [False, False]
    else:
        s = 1.5 + smooth((2,) + n, seed + 3, dm=2)
        s_pad = np.array(js.fill_scal(jnp.asarray(s)))
        adv = [js.adv_bc[js.scal_comp(i)] for i in range(2)]
        cons = [True, False]
    f = smooth((2,) + n, seed + 4, amp=0.3, dm=2)
    f_pad = np.array(js.fill_extrap(jnp.asarray(f), ng))
    rhs_pad = np.array(js.fill_extrap(
        jnp.asarray(smooth(n, seed + 5, amp=0.2, dm=2)), ng))
    return s_pad, jm, tm, f_pad, rhs_pad, adv, cons


@pytest.mark.parametrize("use_minion", [False, True])
@pytest.mark.parametrize("is_vel", [False, True])
@pytest.mark.parametrize("bc", BCS)
def test_mkflux_2d_matches(bc, is_vel, use_minion):
    js, ts = _sims(bc)
    s_pad, jm, tm, f_pad, rhs_pad, adv, cons = _mkflux_case(js, ts, is_vel)
    tail = (2e-3, js.dx, js.phys_bc, adv, js.ng, js.n_cell, is_vel, cons, 4,
            use_minion)
    jargs = (jnp.asarray(s_pad), jm[0], jm[1], jnp.asarray(f_pad),
             jnp.asarray(rhs_pad)) + tail
    ref = jg.mkflux_2d(*jargs)
    ker = jpg.mkflux_2d_fused(*jargs, interpret=True)
    targs = (torch.as_tensor(s_pad), tm[0], tm[1], torch.as_tensor(f_pad),
             torch.as_tensor(rhs_pad)) + tail
    out = tg.mkflux_2d(*targs)
    fused = tcg.mkflux_2d_fused(*targs)
    for i, nm in enumerate(("sedgex", "sedgey", "fluxx", "fluxy")):
        assert out[i].shape == ref[i].shape
        _close(out[i], ref[i], f"mkflux_2d bc={bc} vel={is_vel} {nm}")
        _close(out[i], ker[i], f"mkflux_2d vs pallas bc={bc} {nm}")
        assert torch.equal(fused[i], out[i])
    if not is_vel:  # conservative density: flux = edge * mac; tracer: none
        assert float(out[2][0].abs().max()) > 0.0
        assert float(out[2][1].abs().max()) == 0.0


@pytest.mark.parametrize("bc", [BCS[0], BCS[3]])
def test_mkflux_2d_none_means_zero(bc):
    """force=None and mac_rhs=None give what zero arrays give (the 2-D
    step passes None where varden_tpu passes zeros)."""
    js, ts = _sims(bc)
    s_pad, jm, tm, f_pad, rhs_pad, adv, cons = _mkflux_case(js, ts, False)
    tail = (2e-3, js.dx, js.phys_bc, adv, js.ng, js.n_cell, False, cons, 4,
            False)
    z = jnp.zeros_like(jnp.asarray(s_pad))
    ref = jg.mkflux_2d(jnp.asarray(s_pad), jm[0], jm[1], z, z[0], *tail)
    out = tcg.mkflux_2d_fused(torch.as_tensor(s_pad), tm[0], tm[1], None,
                              None, *tail)
    for i in range(4):
        _close(out[i], ref[i], f"mkflux_2d None bc={bc} out {i}")
