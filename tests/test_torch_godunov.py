"""The port's 3-D Godunov path against varden_tpu's on the same inputs
(float64, CPU): limited slopes, velpred_3d and the velpred kernel
wrapper (its plain version on CPU tensors). Tolerance 1e-12 absolute on O(1) fields: the formulas are the
same op for op, so only library-level roundoff differs."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import ref_jit

from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.ops import godunov3d as jg3
from varden_tpu.ops import slopes as jsl
from varden_tpu.state import Sim as JSim
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.ops import cuda_godunov as tcg
from varden_tpu_torch.ops import godunov3d as tg3
from varden_tpu_torch.ops import slopes as tsl
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


@pytest.mark.parametrize("order", [0, 2, 4])
@pytest.mark.parametrize("bcs", [(1, 3), (3, 2), (2, 1), (0, 0)])
def test_slope_matches(order, bcs):
    rng = np.random.RandomState(order)
    s = rng.randn(22, 9, 7)
    for axis in (0, 1):
        w = jsl.slope(jnp.asarray(s), axis, 3, bcs[0], bcs[1], order,
                      s.shape[axis] - 6, dm=3)
        out = tsl.slope(torch.as_tensor(s), axis, 3, bcs[0], bcs[1], order,
                        s.shape[axis] - 6)
        sl = tuple(slice(w.lo[d], w.hi[d]) for d in range(3))
        _close(out[sl], w.arr, f"slope order={order} axis={axis}")


def _vel_inputs(jsim, seed=7):
    rng = np.random.RandomState(seed)
    n, ng = jsim.n_cell, jsim.ng
    u = 0.5 * rng.randn(3, *n)
    f = 0.3 * rng.randn(3, *n)
    u_pad = np.array(jsim.fill_vel(jnp.asarray(u)))
    f_pad = np.array(jsim.fill_extrap(jnp.asarray(f), ng))
    return u_pad, f_pad


@pytest.mark.parametrize("bc", BCS)
def test_velpred_matches(bc):
    js, ts = _sims(bc)
    u_pad, f_pad = _vel_inputs(js)
    adv = [js.adv_bc[d] for d in range(3)]
    args = (2e-3, js.dx, js.phys_bc, adv, js.ng, js.n_cell, 4, False)
    ref = ref_jit(lambda u, f: jg3.velpred_3d(u, f, *args))(
        jnp.asarray(u_pad), jnp.asarray(f_pad))
    out = tg3.velpred_3d(torch.as_tensor(u_pad), torch.as_tensor(f_pad),
                         *args)
    fused = tcg.velpred_3d_fused(torch.as_tensor(u_pad),
                                 torch.as_tensor(f_pad), *args)
    for d in range(3):
        _close(out[d], ref[d], f"velpred bc={bc} face {d}")
        assert torch.equal(fused[d], out[d])
