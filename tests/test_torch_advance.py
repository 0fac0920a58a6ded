"""One full inviscid 3-D bubble timestep of the port against varden_tpu's
advance_timestep on the same state (float64, CPU, 16x24x16 with isotropic
cells), cold and warm-started. Tolerance 1e-9 relative to each field's
size: both run the same arithmetic and the same V-cycle counts, and the
projections converge to rel_eps 1e-10 (MAC) and 1e-12 (nodal).

The viscous and diffusive steps (16^3; visc_coef, diff_coef, Crank-Nicolson
and backward Euler; viscous_step_matches, which test_torch_advance_visc.py,
_diff.py and _viscdiff.py run) are held to the same 1e-9: their Helmholtz
solves stop at rel_eps 1e-12, where varden_tpu on the CPU smooths with
Jacobi and the port with red-black sweeps, so the two differ by at most
2e-12/min(rho) there (tests/test_torch_visc.py), which the later phases
carry through."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import ref_jit, smooth

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
    jnew, jdiag = ref_jit(lambda s, h: jadv.advance_timestep(
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


# the viscous and diffusive steps, one test file each so that
# --dist loadfile spreads them: test_torch_advance_visc.py (VISC_COEFS[0]),
# _diff.py ([1]) and _viscdiff.py ([2]), Crank-Nicolson and backward Euler
VISC_COEFS = [dict(visc_coef=0.05), dict(diff_coef=0.05),
              dict(visc_coef=0.05, diff_coef=0.02)]


def viscous_step_matches(coefs, diffusion_type):
    """One viscous or diffusive 16^3 step of the port against varden_tpu's
    (the body of test_advance_timestep_viscous_matches)."""
    n = (16, 16, 16)
    kw = dict(KW, n_celly=16, prob_hi_y=1.0, diffusion_type=diffusion_type,
              **coefs)
    js, ts = JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")
    st = jprob.initdata(js)
    arrs = {k: np.array(getattr(st, k)) for k in FIELDS}
    arrs["u"] = arrs["u"] + smooth((3,) + n, 1, amp=0.2)
    arrs["gp"] = smooth((3,) + n, 2, amp=0.5)
    dt, proj_type = 2e-3, 4
    jnew, jdiag = ref_jit(lambda s: jadv.advance_timestep(
        js, s, dt, proj_type))(
        JState(**{k: jnp.asarray(v) for k, v in arrs.items()}))
    tst, _ = state_from_numpy(ts, arrs)
    tnew, tdiag = tadv.advance_timestep(ts, tst, dt, proj_type)
    out, _ = state_to_numpy(tnew)
    for k in FIELDS:
        assert _rel_err(out[k], np.array(getattr(jnew, k))) < 1e-9, k
    for k in ("div_before", "smin", "smax", "umax"):
        assert abs(float(tdiag[k]) - float(jdiag[k])) <= 1e-9 * max(
            1.0, abs(float(jdiag[k]))), k
    assert float(tdiag["mac_ratio"]) <= 1.0 and float(tdiag["hg_ratio"]) <= 1.0
    if "visc_coef" in coefs:
        # mu/dx^2 is small at this dt: sweeps alone settle the viscous solve
        assert tdiag["visc_cycles"] == 0
        assert float(tdiag["visc_ratio"]) <= 1.0
    else:
        assert "visc_cycles" not in tdiag
    # the terms are live: the step differs from the inviscid one
    kw0 = dict(kw, visc_coef=0.0, diff_coef=0.0)
    t0 = TSim(TCfg(**kw0), device="cpu")
    ref0, _ = tadv.advance_timestep(t0, state_from_numpy(t0, arrs)[0], dt,
                                    proj_type)
    moved = "u" if "visc_coef" in coefs else "s"
    assert float((getattr(tnew, moved) - getattr(ref0, moved)).abs().max()) \
        > 1e-6


@pytest.mark.parametrize("over", [{}, dict(bcx_lo=14, bcx_hi=14)])
def test_lap_velocity_and_tracers_match(over):
    """Shared BCs (one batched pass) and differing ones (per component)."""
    kw = dict(KW, **over)
    js, ts = JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")
    u, s = smooth((3,) + N, 7), smooth((2,) + N, 8)
    lu = tadv.lap_velocity(ts, torch.as_tensor(u)).numpy()
    ls = tadv.lap_tracers(ts, torch.as_tensor(s)).numpy()
    ju = np.array(jadv.lap_velocity(js, jnp.asarray(u)))
    jl = np.array(jadv.lap_tracers(js, jnp.asarray(s)))
    assert np.max(np.abs(lu - ju)) <= 1e-11 * np.max(np.abs(ju))
    assert np.max(np.abs(ls - jl)) <= 1e-11 * np.max(np.abs(jl))
    assert np.all(ls[0] == 0.0)
