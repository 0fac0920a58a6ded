"""The port's MAC and nodal projections against varden_tpu on the same
inputs (float64, CPU). Tolerance 1e-9 relative: both run the same
V-cycles to rel_eps 1e-10 (MAC) and 1e-12 (nodal), so they agree to well
inside the solver tolerance. The grid is 16x24x16 with isotropic cells (at
a 1.5:1 cell aspect ratio the nodal V-cycle of both packages stalls far
above its tolerance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_inputs import smooth as _smooth

from varden_tpu import projection as jproj
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.state import Sim as JSim
from varden_tpu_torch import projection as tproj
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.state import Sim as TSim

N = (16, 24, 16)


def _err(t, j):
    return float(np.max(np.abs(t.numpy() - np.asarray(j))))


def _sims(bc, n=N):
    kw = dict(dim_in=3, prob_type=1, n_cellx=n[0], n_celly=n[1],
              n_cellz=n[2], bcx_lo=bc[0], bcx_hi=bc[1], bcy_lo=bc[2],
              bcy_hi=bc[3], bcz_lo=bc[4], bcz_hi=bc[5], grav=-9.8,
              dtype="float64", prob_hi_y=1.5,
              u_bc=((0.7, 0.0), (0.0, 0.0), (0.0, 0.0)))
    return JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")


def _scale_err(t, j):
    return _err(t, j) / max(1.0, float(np.max(np.abs(np.asarray(j)))))


@pytest.mark.parametrize("bc", [(15, 15, 15, 15, 15, 15),
                                (11, 12, -1, -1, 14, 14)])
def test_macproject_matches(bc):
    js, ts = _sims(bc)
    n = js.n_cell
    umac = tuple(_smooth(tuple(n[t] + (1 if t == d else 0) for t in range(3)),
                         10 + d) for d in range(3))
    rho = 5.5 + 9.0 * _smooth(n, 6)
    ref = jax.jit(lambda u, r: jproj.macproject(js, u, r))(
        tuple(jnp.asarray(u) for u in umac), jnp.asarray(rho))
    out = tproj.macproject(ts, tuple(torch.as_tensor(u) for u in umac),
                           torch.as_tensor(rho))
    for d in range(3):
        assert _scale_err(out[0][d], ref[0][d]) < 1e-9
    assert abs(float(out[1]) - float(ref[1])) < 1e-12 * float(ref[1])
    assert abs(float(out[2]) - float(ref[2])) < 1e-9 * float(ref[1])
    assert _scale_err(out[3], ref[3]) < 1e-9


@pytest.mark.parametrize("bc,proj_type", [
    ((15, 15, 15, 15, 15, 15), tproj.INITIAL_PROJECTION),
    ((15, 15, 15, 15, 15, 15), tproj.PRESSURE_ITERS),
    ((11, 12, -1, -1, 14, 14), tproj.REGULAR_TIMESTEP)])
def test_hgproject_matches(bc, proj_type):
    js, ts = _sims(bc)
    n = js.n_cell
    unew = np.stack([_smooth(n, 20 + c) for c in range(3)])
    uold = np.stack([_smooth(n, 30 + c) for c in range(3)])
    rhohalf = 5.5 + 9.0 * _smooth(n, 8)
    gp = np.stack([_smooth(n, 40 + c) for c in range(3)])
    p = _smooth(js.node_shape(), 9)
    dt = 2e-3
    args = (unew, uold, rhohalf, p, gp)
    ref = jax.jit(lambda *a: jproj.hgproject(js, proj_type, *a, dt))(
        *map(jnp.asarray, args))
    out = tproj.hgproject(ts, proj_type, *map(torch.as_tensor, args), dt)
    for k, name in enumerate(("unew", "p", "gp", "phi")):
        assert _scale_err(out[k], ref[k]) < 1e-9, name
    assert float(out[5]) <= 1.0
