"""One full inviscid 3-D bubble timestep of the port against varden_tpu's
advance_timestep on the same state (float64, CPU, 16x24x16 with isotropic
cells), cold and warm-started. Tolerance 1e-9 relative to each field's
size: both run the same arithmetic and the same V-cycle counts, and the
projections converge to rel_eps 1e-10 (MAC) and 1e-12 (nodal)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_inputs import smooth

from varden_tpu import advance as jadv
from varden_tpu import problems as jprob
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.state import Sim as JSim, State as JState
from varden_tpu_torch import advance as tadv
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.state import Sim as TSim, state_from_numpy, state_to_numpy

N = (16, 24, 16)
KW = dict(dim_in=3, prob_type=1, n_cellx=N[0], n_celly=N[1], n_cellz=N[2],
          prob_hi_y=1.5, grav=-9.8, dtype="float64", bcx_lo=15, bcx_hi=15,
          bcy_lo=15, bcy_hi=15, bcz_lo=15, bcz_hi=15)
FIELDS = ("u", "s", "gp", "p")


def _rel_err(a, b):
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


@pytest.mark.parametrize("warm", [False, True])
def test_advance_timestep_matches(warm):
    js, ts = JSim(JCfg(**KW)), TSim(TCfg(**KW), device="cpu")
    st = jprob.initdata(js)
    arrs = {k: np.array(getattr(st, k)) for k in FIELDS}
    arrs["u"] = arrs["u"] + smooth((3,) + N, 1, amp=0.2)
    arrs["gp"] = smooth((3,) + N, 2, amp=0.5)
    hints = None
    if warm:
        ns = js.node_shape()
        hints = {"phi_mac": smooth(N, 3, 1e-3),
                 "phi_mac_prev": smooth(N, 4, 1e-3),
                 "phi_hg": smooth(ns, 5, 1e-3),
                 "phi_hg_prev": smooth(ns, 6, 1e-3)}
    dt, proj_type = 2e-3, 4
    jh = None if hints is None else {k: jnp.asarray(v)
                                     for k, v in hints.items()}
    jnew, jdiag = jax.jit(lambda s, h: jadv.advance_timestep(
        js, s, dt, proj_type, hints=h))(
        JState(**{k: jnp.asarray(v) for k, v in arrs.items()}), jh)
    tst, th = state_from_numpy(ts, arrs, hints)
    tnew, tdiag = tadv.advance_timestep(ts, tst, dt, proj_type, hints=th)
    out, _ = state_to_numpy(tnew)
    for k in FIELDS:
        assert _rel_err(out[k], np.array(getattr(jnew, k))) < 1e-9, k
    for k in ("phi_mac", "phi_hg"):
        assert _rel_err(tdiag[k].numpy(), np.array(jdiag[k])) < 1e-9, k
    for k in ("div_before", "smin", "smax", "umax"):
        assert abs(float(tdiag[k]) - float(jdiag[k])) <= 1e-9 * max(
            1.0, abs(float(jdiag[k]))), k
    assert float(tdiag["div_after"]) < 1e-8 * float(tdiag["div_before"])
    assert float(tdiag["mac_ratio"]) <= 1.0 and float(tdiag["hg_ratio"]) <= 1.0
