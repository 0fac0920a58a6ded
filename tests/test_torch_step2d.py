"""The port's single-level 2-D step against varden_tpu's (float64, CPU).

advance_timestep on one seeded state (inviscid; viscous with Crank-Nicolson
and backward Euler; diffusive), held to 1e-10 relative to each field's size:
both run the same arithmetic and the same solver cycles, and in 2-D both
smooth the Helmholtz fast path with Jacobi, so nothing but roundoff
differs. Whole runs are in tests/test_torch_run2d.py."""
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
from varden_tpu_torch import problems as tprob
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.driver import Varden as TVarden
from varden_tpu_torch.ops import cuda_godunov, cuda_kernels
from varden_tpu_torch.solvers import mg as tmg
from varden_tpu_torch.state import Sim as TSim, state_from_numpy, state_to_numpy

N = (24, 32)
WALLS = dict(bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15)
KW = dict(dim_in=2, prob_type=1, n_cellx=N[0], n_celly=N[1],
          prob_hi_y=N[1] / N[0], grav=-9.8, dtype="float64", **WALLS)
FIELDS = ("u", "s", "gp", "p")


def _rel_err(a, b):
    return float(np.max(np.abs(a - b))) / max(1.0, float(np.max(np.abs(b))))


def _state(js, n):
    st = jprob.initdata(js)
    arrs = {k: np.array(getattr(st, k)) for k in FIELDS}
    arrs["u"] = arrs["u"] + smooth((2,) + n, 1, amp=0.2, dm=2)
    arrs["gp"] = smooth((2,) + n, 2, amp=0.5, dm=2)
    return arrs


CASES = {
    "inviscid": {},
    "cn": dict(visc_coef=0.05),
    "cn-vcycle": dict(visc_coef=20.0),
    "diffusive": dict(diff_coef=0.05),
    "both-be": dict(visc_coef=0.05, diff_coef=0.02, diffusion_type=2),
    "periodic-x": dict(bcx_lo=-1, bcx_hi=-1, visc_coef=0.05),
    "inlet-outlet": dict(bcx_lo=11, bcx_hi=12, bcy_lo=14, bcy_hi=14,
                         u_bc=((1.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
                         rho_bc=((1.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
                         visc_coef=0.05),
}


# every case from a cold start; two of them again with warm-start hints
@pytest.mark.parametrize("case,warm", [(c, False) for c in sorted(CASES)]
                         + [("cn", True), ("inlet-outlet", True)])
def test_advance_timestep_2d_matches(case, warm):
    kw = dict(KW, **CASES[case])
    js, ts = JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")
    arrs = _state(js, N)
    hints = None
    if warm:
        ns = js.node_shape()
        hints = {"phi_mac": smooth(N, 3, 1e-3, dm=2),
                 "phi_mac_prev": smooth(N, 4, 1e-3, dm=2),
                 "phi_hg": smooth(ns, 5, 1e-3, dm=2),
                 "phi_hg_prev": smooth(ns, 6, 1e-3, dm=2)}
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
        assert out[k].shape == np.array(getattr(jnew, k)).shape
        assert _rel_err(out[k], np.array(getattr(jnew, k))) < 1e-10, k
    for k in ("phi_mac", "phi_hg"):
        assert _rel_err(tdiag[k].numpy(), np.array(jdiag[k])) < 1e-10, k
    for k in ("div_before", "smin", "smax", "umax"):
        assert abs(float(tdiag[k]) - float(jdiag[k])) <= 1e-10 * max(
            1.0, abs(float(jdiag[k]))), k
    assert float(tdiag["div_after"]) < 1e-7 * float(tdiag["div_before"])
    assert float(tdiag["mac_ratio"]) <= 1.0 and float(tdiag["hg_ratio"]) <= 1.0
    if kw.get("visc_coef", 0.0) > 0.0:
        # small mu/dx^2: Jacobi sweeps alone settle the viscous solve;
        # visc_coef 20: gamma above 0.5, V-cycles
        assert (tdiag["visc_cycles"] == 0) == (case != "cn-vcycle")
        assert float(tdiag["visc_ratio"]) <= 1.0
    else:
        assert "visc_cycles" not in tdiag


@pytest.mark.parametrize("case", ["cn", "diffusive"])
def test_the_2d_terms_are_live(case):
    kw = dict(KW, **CASES[case])
    ts = TSim(TCfg(**kw), device="cpu")
    t0 = TSim(TCfg(**KW), device="cpu")
    arrs = _state(JSim(JCfg(**kw)), N)
    new, _ = tadv.advance_timestep(ts, state_from_numpy(ts, arrs)[0], 2e-3, 4)
    ref, _ = tadv.advance_timestep(t0, state_from_numpy(t0, arrs)[0], 2e-3, 4)
    moved = "u" if case == "cn" else "s"
    assert float((getattr(new, moved) - getattr(ref, moved)).abs().max()) \
        > 1e-6


def test_the_2d_step_goes_through_the_2d_wrappers():
    """One viscous step calls velpred_2d_fused once, mkflux_2d_fused twice
    and gsrb_sweep_2d many times, and none of the 3-D wrappers."""
    names = {cuda_godunov: ["velpred_2d_fused", "mkflux_2d_fused",
                            "velpred_3d_fused", "mkflux_update_3d_fused"],
             cuda_kernels: ["gsrb_sweep_2d", "gsrb_var_sweep_3d",
                            "gsrb_const_sweep_3d", "nodal_sweep_3d"]}
    calls, saved = {}, []
    for mod, fns in names.items():
        for nm in fns:
            real = getattr(mod, nm)
            saved.append((mod, nm, real))

            def spy(*a, _real=real, _nm=nm, **k):
                calls[_nm] = calls.get(_nm, 0) + 1
                for t in a:
                    if torch.is_tensor(t):
                        assert t.is_contiguous(), _nm
                return _real(*a, **k)

            setattr(mod, nm, spy)
    try:
        kw = dict(KW, visc_coef=1e-3)
        ts = TSim(TCfg(**kw), device="cpu")
        arrs = _state(JSim(JCfg(**kw)), N)
        tadv.advance_timestep(ts, state_from_numpy(ts, arrs)[0], 2e-3, 4)
    finally:
        for mod, nm, real in saved:
            setattr(mod, nm, real)
    assert calls["velpred_2d_fused"] == 1 and calls["mkflux_2d_fused"] == 2
    assert calls["gsrb_sweep_2d"] > 10
    assert not any(k.endswith("3d") or "3d_" in k for k in calls), calls


@pytest.mark.parametrize("bc", [WALLS, dict(bcx_lo=-1, bcx_hi=-1, bcy_lo=12,
                                            bcy_hi=12)])
def test_lap_velocity_and_tracers_2d_match(bc):
    kw = dict(KW, **bc)
    js, ts = JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")
    u, s = smooth((2,) + N, 7, dm=2), smooth((2,) + N, 8, dm=2)
    lu = tadv.lap_velocity(ts, torch.as_tensor(u)).numpy()
    ls = tadv.lap_tracers(ts, torch.as_tensor(s)).numpy()
    ju = np.array(jadv.lap_velocity(js, jnp.asarray(u)))
    jl = np.array(jadv.lap_tracers(js, jnp.asarray(s)))
    assert np.max(np.abs(lu - ju)) <= 1e-11 * np.max(np.abs(ju))
    assert np.max(np.abs(ls - jl)) <= 1e-11 * np.max(np.abs(jl))
    assert np.all(ls[0] == 0.0)


@pytest.mark.parametrize("prob_type", [1, 2, 3])
def test_initdata_2d_matches(prob_type):
    kw = dict(KW, prob_type=prob_type)
    js, ts = JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")
    a, b = jprob.initdata(js), tprob.initdata(ts)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(b, k).numpy(),
                                   np.array(getattr(a, k)), atol=1e-14)
    if prob_type == 1:   # the 2-D bubble's density contrast is 2
        assert 1.0 <= float(b.s[0].min()) and float(b.s[0].max()) <= 2.0
    arrs, _ = state_to_numpy(b)
    st2, _ = state_from_numpy(ts, arrs)
    for k in FIELDS:
        assert torch.equal(getattr(b, k), getattr(st2, k))
    assert st2.p.shape == ts.node_shape() == js.node_shape()


def test_dm2_is_supported_and_amr_still_raises(monkeypatch):
    """2-D runs are supported, multi-level ones too (the AMR slice), and
    under a mesh (AMR on a process group of two ranks decomposes every
    patch); a multi-level run under a mesh still raises where the mesh is
    not the group's size."""
    import torch.distributed as dist
    cfg = TCfg(**KW)
    assert TVarden(cfg, device="cpu").sim.dm == 2
    assert TVarden(TCfg(**dict(KW, max_levs=2)), device="cpu").ml
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    v = TVarden(TCfg(**dict(KW, max_levs=2, mesh=2)), device="cpu")
    assert v.ml and v.sim.ml_ranks == 2
    with pytest.raises(ValueError, match="2 ranks"):
        TVarden(TCfg(**dict(KW, max_levs=2, mesh=4)), device="cpu")
    monkeypatch.undo()
    lev = tmg.make_level((8, 8), (0.1, 0.1), [(1, 1)] * 2, torch.zeros(8, 8),
                         (1.0, 1.0), 0.0)
    assert tmg.cc_apply(lev, torch.ones(8, 8)).abs().max() == 0.0
