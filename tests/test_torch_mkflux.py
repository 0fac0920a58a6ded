"""The port's mkflux_3d, the update epilogue and the fused
mkflux+update wrapper (its plain version on CPU tensors), with and without
its flux option, against varden_tpu's on the same inputs (float64, CPU; the
flux option against varden_tpu's kernel in interpret mode). Tolerance 1e-12 absolute on O(1) fields: the formulas are the
same op for op, so only library-level roundoff differs."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import ref_jit

from varden_tpu import advance as jadv
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.ops import godunov3d as jg3
from varden_tpu.ops import pallas_godunov as jpg
from varden_tpu.state import Sim as JSim
from varden_tpu_torch import advance as tadv
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.ops import cuda_godunov as tcg
from varden_tpu_torch.ops import godunov3d as tg3
from varden_tpu_torch.state import Sim as TSim

TOL = 1e-12
N = (16, 24, 16)
BCS = [(15, 15, 15), (-1, -1, -1), (-1, 15, 12)]


def _sims(bc, n=N):
    kw = dict(dim_in=3, prob_type=1, n_cellx=n[0], n_celly=n[1],
              n_cellz=n[2], bcx_lo=bc[0], bcx_hi=bc[0], bcy_lo=bc[1],
              bcy_hi=bc[1], bcz_lo=bc[2], bcz_hi=bc[2], grav=-9.8,
              dtype="float64")
    return JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")


def _close(t, j, what):
    err = float(np.max(np.abs(t.numpy() - np.asarray(j))))
    assert err < TOL, f"{what}: {err}"


@pytest.mark.parametrize("bc,is_vel,with_force", [
    ((15, 15, 15), False, False), ((15, 15, 15), False, True),
    ((-1, 15, 12), True, True), ((-1, -1, -1), True, False)])
def test_mkflux_update_matches(bc, is_vel, with_force):
    js, ts = _sims(bc)
    n, ng = js.n_cell, js.ng
    rng = np.random.RandomState(9)
    umac = tuple(rng.rand(*[n[t] + (1 if t == d else 0)
                            for t in range(3)]) - 0.5 for d in range(3))
    jmac = jadv.embed_faces(js, tuple(jnp.asarray(u) for u in umac), ng)
    tmac = tadv.embed_faces(ts, tuple(torch.as_tensor(u) for u in umac), ng)
    for a, b in zip(jmac, tmac):
        np.testing.assert_array_equal(b.numpy(), np.array(a))
    if is_vel:
        s = 0.5 * rng.randn(3, *n)
        s_pad = np.array(js.fill_vel(jnp.asarray(s)))
        adv = [js.adv_bc[d] for d in range(3)]
        cons = [False] * 3
    else:
        s = 1.0 + rng.rand(2, *n)
        s_pad = np.array(js.fill_scal(jnp.asarray(s)))
        adv = [js.adv_bc[js.scal_comp(i)] for i in range(2)]
        cons = [True, False]
    nc = s.shape[0]
    f_pad = (np.array(js.fill_extrap(jnp.asarray(0.2 * rng.randn(nc, *n)), ng))
             if with_force else None)
    fupd = 0.1 * rng.randn(nc, *n) if with_force else None
    rhs_pad = (np.array(js.fill_extrap(jnp.asarray(0.1 * rng.randn(*n)), ng))
               if with_force else None)
    dt = 2e-3
    tail = (dt, js.dx, js.phys_bc, adv, ng, n, is_vel, cons, 4, False)

    def jref(s_pad, mac, f_pad, rhs_pad, fupd):
        sedge, sflux = jg3.mkflux_3d(s_pad, mac, f_pad, rhs_pad, *tail)
        umac_i = jpg._mac_interior(mac, ng, n)
        sold = s_pad[(slice(None),) + tuple(slice(ng, ng + n[t])
                                            for t in range(3))]
        return sedge, sflux, jpg._update_vals(sold, umac_i, sedge, sflux,
                                              fupd, dt, js.dx, cons)

    J = lambda a: None if a is None else jnp.asarray(a)
    T = lambda a: None if a is None else torch.as_tensor(a)
    ref_e, ref_f, ref_new = ref_jit(jref)(J(s_pad), jmac, J(f_pad),
                                          J(rhs_pad), J(fupd))
    out_e, out_f = tg3.mkflux_3d(T(s_pad), tmac, T(f_pad), T(rhs_pad), *tail)
    for d in range(3):
        _close(out_e[d], ref_e[d], f"sedge {d}")
        _close(out_f[d], ref_f[d], f"sflux {d}")
    snew = tcg.mkflux_update_3d_fused(T(s_pad), tmac, T(f_pad), T(fupd),
                                      T(rhs_pad), *tail)
    _close(snew, ref_new, "snew")
    # the flux option (the AMR scalar advance's call): snew and the listed
    # components' conservative fluxes (zero for a convective one) against
    # varden_tpu's kernel in interpret mode
    fc = (0, 2) if is_vel else (0,)
    kern = ref_jit(lambda s_, m_, f_, r_, u_: jpg.mkflux_update_3d_fused(
        s_, m_, f_, u_, r_, *tail, flux_comps=fc, interpret=True))
    ref_new2, ref_fl = kern(J(s_pad), jmac, J(f_pad), J(rhs_pad), J(fupd))
    snew2, sflux2 = tcg.mkflux_update_3d_fused(
        T(s_pad), tmac, T(f_pad), T(fupd), T(rhs_pad), *tail, flux_comps=fc)
    _close(snew2, ref_new2, "snew with fluxes")
    for d in range(3):
        assert tuple(sflux2[d].shape) == tuple(ref_fl[d].shape)
        _close(sflux2[d], ref_fl[d], f"flux {d}")
        _close(sflux2[d], np.asarray(ref_f[d])[list(fc)], f"flux {d} rows")
