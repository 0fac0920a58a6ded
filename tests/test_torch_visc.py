"""The port's Helmholtz solves against varden_tpu on the same inputs
(float64, CPU): mg.solve with alpha = 1 and scalar beta on its fast path
(small mu: sweeps only) and on its V-cycle branch (large mu: gamma >= 0.5),
batched and unbatched, then visc_solve and diff_scalar_solve.

Tolerance. On the CPU varden_tpu smooths its fast path with Jacobi sweeps,
the port (on the CPU and on the card alike) with the red-black sweep the
TPU path uses, so the two solutions agree to the solver's tolerance, not
to roundoff. Both stop at max|r| <= tol, and A = alpha*aco - mu lap is an
M-matrix whose row sums are at least alpha*aco, so ||A^-1||_inf <=
1/min(alpha*aco) and
    max|phi_port - phi_jax| <= (|r_port| + |r_jax|)/min(alpha*aco)
                            <= 2 tol/min(alpha*aco).
On the V-cycle branch both run the same cycles (exact red-black sweeps, the
dense bottom), and the same bound is asserted."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_inputs import smooth

from varden_tpu import projection as jproj
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.solvers import mg as jmg
from varden_tpu.state import Sim as JSim
from varden_tpu_torch import projection as tproj
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.solvers import mg as tmg
from varden_tpu_torch.state import Sim as TSim

N = (16, 16, 16)
DX = (1.0 / 16,) * 3
REL_EPS = 1e-12
MU_FAST, MU_MG = 1e-4, 0.05   # gamma about 0.15 and about 0.99
BC_SETS = {
    "walls": ([(2, 2)] * 3, [[0.0, 0.0]] * 3),
    "mixed": ([(0, 0), (1, 2), (2, 1)], [[0.0, 0.0], [0.0, 0.3], [-0.2, 0.0]]),
}


def _err(t, j):
    return float(np.max(np.abs(t.numpy() - np.asarray(j))))


def _tol(rhs, phi, diag_max):
    """The solvers' effective tolerance (mg.solve tol_eff)."""
    return max(REL_EPS * float(np.max(np.abs(rhs))),
               4.0 * np.finfo(np.float64).eps * diag_max
               * float(np.max(np.abs(phi))))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("mu", [MU_FAST, MU_MG])
@pytest.mark.parametrize("bc", sorted(BC_SETS))
def test_helmholtz_solve_matches(bc, mu, batched):
    ell_bc, bvals = BC_SETS[bc]
    aco = 1.0 + 4.5 * (1.0 + smooth(N, 1, amp=1.0))      # in [1, 10]
    shape = (3,) + N if batched else N
    rhs = smooth(shape, 2, amp=2.0)
    phi0 = smooth(shape, 3, amp=0.5)
    kw = dict(alpha=1.0, bvals=bvals, rel_eps=REL_EPS, abs_eps=-1.0,
              return_info=True)
    pj, (rn_j, it_j, ratio_j) = jax.jit(lambda a, r, p: jmg.solve(
        N, DX, ell_bc, a, (mu,) * 3, r, phi0=p, **kw))(
        jnp.asarray(aco), jnp.asarray(rhs), jnp.asarray(phi0))
    pt, (rn_t, it_t, ratio_t) = tmg.solve(
        N, DX, ell_bc, torch.as_tensor(aco), (mu,) * 3, torch.as_tensor(rhs),
        phi0=torch.as_tensor(phi0), **kw)
    assert float(ratio_t) <= 1.0 and float(ratio_j) <= 1.0
    if mu == MU_FAST:
        assert it_t == 0 and int(it_j) == 0       # sweeps alone settled it
    else:
        assert it_t == int(it_j) > 0              # the same V-cycles
    lev = tmg.make_level(N, DX, ell_bc, torch.as_tensor(aco), (mu,) * 3, 1.0)
    tol = _tol(rhs, np.asarray(pj), float(lev.diag.max()))
    assert float(rn_t) <= tol and float(rn_j) <= tol
    assert _err(pt, pj) <= 2.0 * tol / aco.min()
    # and the port's answer solves the system (an independent residual)
    res = torch.as_tensor(rhs) - tmg.cc_apply(lev, pt, bvals)
    assert float(res.abs().max()) <= 1.01 * tol


def test_fast_path_sweep_budget_and_guards():
    """k_smooth from the measured residual: a warm start already inside the
    tolerance runs no sweep and keeps phi0; a non-finite one falls through
    to the V-cycle loop without sweeps."""
    from varden_tpu_torch.ops import cuda_kernels as ck
    ell_bc, bvals = BC_SETS["walls"]
    aco = torch.ones(N, dtype=torch.float64)
    rhs = torch.as_tensor(smooth(N, 4))
    kw = dict(alpha=1.0, bvals=bvals, rel_eps=REL_EPS, return_info=True)
    calls = []
    real = ck.gsrb_const_sweep_3d

    def spy(*a, emit="sweep", **k):
        calls.append(emit)
        return real(*a, emit=emit, **k)

    ck.gsrb_const_sweep_3d = spy
    try:
        phi, (rn, iters, ratio) = tmg.solve(N, DX, ell_bc, aco, (MU_FAST,) * 3,
                                            rhs, **kw)
        k = calls.count("sweep")
        assert iters == 0 and 1 <= k <= 40 and float(ratio) <= 1.0
        assert calls.count("residual") == 2       # rin and the final check
        calls.clear()
        phi2, (rn2, iters2, _) = tmg.solve(N, DX, ell_bc, aco, (MU_FAST,) * 3,
                                           rhs, phi0=phi, **kw)
        assert calls == ["residual"] and iters2 == 0
        assert phi2 is phi and float(rn2) == float(rn)
    finally:
        ck.gsrb_const_sweep_3d = real
    bad = torch.full_like(rhs, float("nan"))
    _, (rn3, iters3, _) = tmg.solve(N, DX, ell_bc, aco, (MU_FAST,) * 3, rhs,
                                    phi0=bad, max_cycles=2, **kw)
    assert not np.isfinite(float(rn3)) and iters3 == 0


def _sims(**over):
    kw = dict(dim_in=3, prob_type=1, n_cellx=16, n_celly=16, n_cellz=16,
              grav=-9.8, dtype="float64", bcx_lo=15, bcx_hi=15, bcy_lo=15,
              bcy_hi=15, bcz_lo=15, bcz_hi=15)
    kw.update(over)
    return JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")


# no-slip walls: one operator for the three components (one batched solve);
# slip walls in x: the normal and the tangential components differ there
@pytest.mark.parametrize("diffusion_type", [1, 2])
@pytest.mark.parametrize("bc", ["no_slip", "slip_x", "inflow_x"])
def test_visc_solve_matches(bc, diffusion_type):
    over = {"no_slip": {}, "slip_x": dict(bcx_lo=14, bcx_hi=14),
            "inflow_x": dict(bcx_lo=11, bcx_hi=12,
                             u_bc=((0.5, 0.0), (0.0, 0.0), (0.0, 0.0)))}[bc]
    js, ts = _sims(**over)
    shared = all(js.ell_bc[d] == js.ell_bc[0] and js.bvals[d] == js.bvals[0]
                 for d in range(3))
    assert shared == (bc == "no_slip")
    unew = smooth((3,) + N, 5, amp=0.4)
    lapu = smooth((3,) + N, 6, amp=3.0)
    rho = 1.0 + 4.5 * (1.0 + smooth(N, 7, amp=1.0))
    mu = 0.5 * 2e-3 * 1e-1                       # dt 2e-3, visc_coef 0.1
    pj = jax.jit(lambda u, l, r: jproj.visc_solve(
        js, u, l, r, jnp.zeros(N), mu, diffusion_type))(
        jnp.asarray(unew), jnp.asarray(lapu), jnp.asarray(rho))
    pt = tproj.visc_solve(ts, torch.as_tensor(unew), torch.as_tensor(lapu),
                          torch.as_tensor(rho), None, mu, diffusion_type)
    assert pt.shape == (3,) + N
    # tol: rel_eps 1e-12 of max|rhs| <= max|rho u| + mu max|lapu| < 5
    assert _err(pt, pj) <= 2.0 * (REL_EPS * 5.0) / rho.min()
    assert _err(pt, unew) > 1e-6                 # the solve did move u


def test_visc_solve_with_a_divergence_source_matches():
    """mac_rhs is None (statically zero) on the port's timestep; given a
    field, its (1/3) mu dt grad(divu) term enters the right-hand side as in
    varden_tpu, with return_info as mg.solve gives it."""
    js, ts = _sims()
    unew = smooth((3,) + N, 5, amp=0.4)
    lapu = smooth((3,) + N, 6, amp=3.0)
    rho = 1.0 + 4.5 * (1.0 + smooth(N, 7, amp=1.0))
    mrhs = smooth(N, 12, amp=50.0)
    mu = 0.5 * 2e-3 * 1e-1
    pad = js.fill_extrap(jnp.asarray(mrhs), 1)
    tpad = ts.fill_extrap(torch.as_tensor(mrhs), 1)
    for d in range(3):
        assert _err(tproj._grad_cc(tpad, d, 3, DX[d]),
                    jproj._grad_cc(pad, d, 3, DX[d])) < 1e-11
    pj = jax.jit(lambda u, l, r, m: jproj.visc_solve(js, u, l, r, m, mu, 1))(
        jnp.asarray(unew), jnp.asarray(lapu), jnp.asarray(rho),
        jnp.asarray(mrhs))
    pt, (rn, cycles, ratio) = tproj.visc_solve(
        ts, torch.as_tensor(unew), torch.as_tensor(lapu), torch.as_tensor(rho),
        torch.as_tensor(mrhs), mu, 1, return_info=True)
    assert cycles == 0 and float(ratio) <= 1.0
    assert _err(pt, pj) <= 2.0 * (REL_EPS * 5.0) / rho.min()
    p0 = tproj.visc_solve(ts, torch.as_tensor(unew), torch.as_tensor(lapu),
                          torch.as_tensor(rho), None, mu, 1)
    assert _err(pt, p0.numpy()) > 1e-6           # the term is live


@pytest.mark.parametrize("diffusion_type", [1, 2])
def test_diff_scalar_solve_matches(diffusion_type):
    js, ts = _sims()
    snew = np.stack([1.0 + 4.5 * (1.0 + smooth(N, 8, amp=1.0)),
                     smooth(N, 9, amp=0.5)])
    laps = smooth((2,) + N, 10, amp=3.0)
    mu = 0.5 * 2e-3 * 1e-1
    pj = jax.jit(lambda s, l: jproj.diff_scalar_solve(
        js, s, l, mu, diffusion_type))(jnp.asarray(snew), jnp.asarray(laps))
    pt = tproj.diff_scalar_solve(ts, torch.as_tensor(snew),
                                 torch.as_tensor(laps), mu, diffusion_type)
    assert _err(pt[0], snew[0]) == 0.0           # density is not diffused
    # aco = 1; tol: rel_eps 1e-12 of max|rhs| < 1
    assert _err(pt, pj) <= 2.0 * REL_EPS
    assert _err(pt[1], snew[1]) > 1e-6


@pytest.mark.parametrize("comp", [0, 3, 4])
def test_explicit_diffusive_term_matches(comp):
    js, ts = _sims(bcy_lo=11, bcy_hi=12,
                   u_bc=((0.0, 0.0), (0.5, 0.0), (0.0, 0.0)),
                   trac_bc=((0.0, 0.0), (0.3, 0.0), (0.0, 0.0)))
    f = smooth(N, 11)
    ref = jproj.get_explicit_diffusive_term(js, jnp.asarray(f), comp)
    out = tproj.get_explicit_diffusive_term(ts, torch.as_tensor(f), comp)
    assert _err(out, ref) <= 1e-11 * float(np.max(np.abs(ref)))
