"""The port's cell-centred multigrid and the gsrb_var_sweep_3d wrapper (its
plain version on CPU tensors) against varden_tpu on the same inputs
(float64, CPU): cc_apply, the exact red-black sweep against the jnp
mg.gsrb, the residual and restrict emits against the TPU kernel in
interpret mode, and mg.solve on a MAC operator with each bottom solver.
Tolerances: 1e-11 for operator applications and sweeps (the same
arithmetic, summed in another order); 1e-9 relative for solves with the
dense bottom (both run the same V-cycles to rel_eps 1e-10); 1e-8 relative
with the iterative bottoms, whose stop tests (1e-3 of the bottom residual)
may fall on either side of a roundoff-level difference, so that only the
solver's own tolerance bounds the difference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varden_tpu.ops import pallas_kernels as jpk
from varden_tpu.solvers import mg as jmg
from varden_tpu_torch.ops import cuda_kernels as tck
from varden_tpu_torch.solvers import mg as tmg

DX = (0.1, 0.11, 0.12)
CASES = [
    ((16, 8, 32), [(1, 2), (2, 1), (0, 0)]),
    ((15, 9, 8), [(0, 0), (1, 1), (2, 2)]),
]


def _problem(n, ell_bc, seed=7):
    rng = np.random.RandomState(seed)
    beta = [0.5 + rng.rand(*[n[t] + (1 if t == d else 0) for t in range(3)])
            for d in range(3)]
    phi = rng.rand(*n) - 0.5
    rhs = rng.rand(*n) - 0.5
    jl = jmg.make_level(n, DX, ell_bc, jnp.zeros(n),
                        tuple(jnp.asarray(b) for b in beta), 0.0)
    tl = tmg.make_level(n, DX, ell_bc, torch.zeros(n),
                        tuple(torch.as_tensor(b) for b in beta), 0.0)
    return jl, tl, beta, phi, rhs


def _err(t, j):
    return float(np.max(np.abs(t.numpy() - np.asarray(j))))


@pytest.mark.parametrize("n,ell_bc", CASES)
def test_cc_apply_and_gsrb_match(n, ell_bc):
    jl, tl, beta, phi, rhs = _problem(n, ell_bc)
    bv = [[0.0, 0.3], [0.15, 0.0], [0.0, 0.0]]
    assert _err(tl.diag, jl.diag) < 1e-11
    ref = jmg.cc_apply(jl, jnp.asarray(phi), bv)
    assert _err(tmg.cc_apply(tl, torch.as_tensor(phi), bv), ref) < 1e-11
    res = tmg._residual(tl, torch.as_tensor(phi), torch.as_tensor(rhs), bv)
    assert _err(res, jnp.asarray(rhs) - ref) < 1e-11
    ref = jax.jit(lambda p, r: jmg.gsrb(jl, p, r, bv, 3))(
        jnp.asarray(phi), jnp.asarray(rhs))
    out = tmg.gsrb(tl, torch.as_tensor(phi), torch.as_tensor(rhs), bv, 3)
    assert _err(out, ref) < 1e-11


def test_residual_and_restrict_emits_match_the_tpu_kernel():
    n, ell_bc = CASES[0]
    jl, tl, beta, phi, rhs = _problem(n, ell_bc, seed=3)
    bv = [[0.0, 0.3], [0.15, 0.0], [0.0, 0.0]]
    jb = tuple(jnp.asarray(b) for b in beta)
    tb = tuple(torch.as_tensor(b) for b in beta)
    inv = 1.0 / np.asarray(jl.diag)
    args_j = (jnp.asarray(phi), jnp.asarray(rhs), jnp.asarray(inv), jb, DX,
              ell_bc, bv)
    args_t = (torch.as_tensor(phi), torch.as_tensor(rhs),
              torch.as_tensor(inv), tb, DX, ell_bc, bv)
    r_j = jpk.gsrb_var_sweep_3d(*args_j, emit="residual", interpret=True)
    r_t = tck.gsrb_var_sweep_3d(*args_t, emit="residual")
    assert _err(r_t, r_j) < 1e-11
    (c_j, m_j) = jpk.gsrb_var_sweep_3d(*args_j, emit="restrict",
                                       interpret=True)
    (c_t, m_t) = tck.gsrb_var_sweep_3d(*args_t, emit="restrict")
    assert _err(c_t, c_j) < 1e-11
    assert abs(float(m_t) - float(m_j)) < 1e-11
    # the exact sweep is the jnp mg.gsrb (the TPU kernel's tiled hybrid
    # sweep is not, see pallas_kernels.py:11-13)
    s_t = tck.gsrb_var_sweep_3d(*args_t)
    s_j = jmg.gsrb(jl, jnp.asarray(phi), jnp.asarray(rhs), bv, 1)
    assert _err(s_t, s_j) < 1e-11


@pytest.mark.parametrize("ell_bc", [[(1, 1)] * 3, [(2, 1), (1, 1), (0, 0)]])
def test_solve_on_a_mac_operator(ell_bc):
    n = (16, 24, 16)
    rng = np.random.RandomState(5)
    rho = 1.0 + 9.0 * rng.rand(*[s + 2 for s in n])
    beta = []
    for d in range(3):
        q = rho[tuple(slice(1, -1) if t != d else slice(None)
                      for t in range(3))]
        beta.append(2.0 / (q[tuple(slice(1, None) if t == d else slice(None)
                                   for t in range(3))]
                           + q[tuple(slice(0, -1) if t == d else slice(None)
                                     for t in range(3))]))
    rhs = rng.rand(*n) - 0.5
    dx = (1.0 / 16, 1.0 / 24, 1.0 / 16)
    kw = dict(alpha=0.0, rel_eps=1e-10, abs_eps=-1.0, return_info=True)
    pj, (rn_j, it_j, _) = jax.jit(lambda b, r: jmg.solve(
        n, dx, ell_bc, jnp.zeros(n), b, r, **kw))(
        tuple(jnp.asarray(b) for b in beta), jnp.asarray(rhs))
    pt, (rn_t, it_t, ratio) = tmg.solve(
        n, dx, ell_bc, torch.zeros(n), tuple(torch.as_tensor(b) for b in beta),
        torch.as_tensor(rhs), **kw)
    assert int(it_t) == int(it_j)
    assert float(ratio) <= 1.0
    scale = float(np.max(np.abs(np.asarray(pj))))
    assert _err(pt, pj) < 1e-9 * scale


def _mac_problem(n, seed=5):
    rng = np.random.RandomState(seed)
    rho = 1.0 + 9.0 * rng.rand(*[s + 2 for s in n])
    beta = []
    for d in range(3):
        q = rho[tuple(slice(1, -1) if t != d else slice(None)
                      for t in range(3))]
        beta.append(2.0 / (q[tuple(slice(1, None) if t == d else slice(None)
                                   for t in range(3))]
                           + q[tuple(slice(0, -1) if t == d else slice(None)
                                     for t in range(3))]))
    return beta, rng.rand(*n) - 0.5


@pytest.mark.parametrize("bottom", ["smoother", "cg", "bicgstab"])
@pytest.mark.parametrize("ell_bc", [[(1, 1)] * 3, [(2, 1), (1, 1), (0, 0)]])
def test_solve_with_each_bottom_solver(ell_bc, bottom):
    n = (16, 16, 16)
    beta, rhs = _mac_problem(n)
    dx = (1.0 / 16,) * 3
    kw = dict(alpha=0.0, rel_eps=1e-10, abs_eps=-1.0, return_info=True,
              bottom=bottom)
    pj, (rn_j, it_j, ratio_j) = jax.jit(lambda b, r: jmg.solve(
        n, dx, ell_bc, jnp.zeros(n), b, r, **kw))(
        tuple(jnp.asarray(b) for b in beta), jnp.asarray(rhs))
    pt, (rn_t, it_t, ratio_t) = tmg.solve(
        n, dx, ell_bc, torch.zeros(n), tuple(torch.as_tensor(b) for b in beta),
        torch.as_tensor(rhs), **kw)
    # ten smoothing sweeps are a weak bottom solver: on some of these
    # problems both packages stall above the tolerance (ratio > 1), after
    # the same number of cycles; the Krylov bottoms converge
    assert int(it_t) == int(it_j)
    assert abs(float(ratio_t) - float(ratio_j)) <= 1e-2 * float(ratio_j)
    if bottom != "smoother":
        assert float(ratio_t) <= 1.0
    scale = float(np.max(np.abs(np.asarray(pj))))
    assert _err(pt, pj) < 1e-8 * scale


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
@pytest.mark.parametrize("singular", [False, True])
def test_krylov_bottom_matches(method, singular):
    """One bottom solve on an 8^3 level, batched (3 right-hand sides, one of
    them zero: the frozen-element guard), against the jnp one. Both stop at
    1e-3 of the residual, after the same iterations: CG agrees to 1e-9;
    BiCGStab's recurrences enlarge the roundoff of its dot products (summed
    in another order), so it is held to 1e-6, still a thousandth of the
    bottom solve's own accuracy."""
    n = (8, 8, 8)
    ell_bc = [(1, 1)] * 3 if singular else [(2, 1), (1, 1), (0, 0)]
    beta, _ = _mac_problem(n, seed=9)
    rng = np.random.RandomState(4)
    r = rng.rand(3, *n) - 0.5
    r[1] = 0.0
    jl = jmg.make_level(n, DX, ell_bc, jnp.zeros(n),
                        tuple(jnp.asarray(b) for b in beta), 0.0)
    tl = tmg.make_level(n, DX, ell_bc, torch.zeros(n),
                        tuple(torch.as_tensor(b) for b in beta), 0.0)
    ref = jmg.bottom_solve(jl, jnp.asarray(r), singular, method)
    out = tmg.bottom_solve(tl, torch.as_tensor(r), singular, method)
    assert bool(torch.isfinite(out).all())
    assert float(out[1].abs().max()) == 0.0
    rtol = 1e-9 if method == "cg" else 1e-6
    assert _err(out, ref) < rtol * float(np.max(np.abs(np.asarray(ref))))
    # and it did reduce the residual a thousandfold
    rr = torch.as_tensor(r)
    if singular:
        rr = rr - rr.mean(dim=(1, 2, 3), keepdim=True)
    res = rr - tmg.cc_apply(tl, out)
    if singular:
        res = res - res.mean(dim=(1, 2, 3), keepdim=True)
    assert float(res.abs().max()) <= 1.0e-3 * float(rr.abs().max())
