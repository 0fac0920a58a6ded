"""The fused multigrid stages of kernel 8, gsrb_sweep_2d's "smooth" and
"smooth_restrict" (their plain versions on CPU tensors, which the 2-D
V-cycles run on the CPU), against varden_tpu composed the same way, at 16^2
and 15 x 9 in float64:

  "smooth": phi + the piecewise-constant prolongation of a coarse
    correction at cfac (2, 2), (1, 2) or (2, 1), then two exact red-black
    sweeps (varden_tpu's mg.gsrb);
  "smooth_restrict": two sweeps, then the residual rhs - cc_apply(phi), its
    2x2 average (varden_tpu's mg._cell_avg_down) and max|r|.

Every elliptic BC code (periodic 0, Neumann 1, Dirichlet 2 with non-zero
face values, coarse-fine ghost 3) and an odd extent, where only "smooth"
is taken. Tolerance: 1e-12 of each field's largest value (the same
arithmetic, the residual summed in another order). A 2-D MAC solve gives
the same phi, cycle count and ratio through the fused stages as through
the single passes, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import smooth

from varden_tpu.solvers import mg as jmg
from varden_tpu_torch.ops import cuda_kernels as tck
from varden_tpu_torch.solvers import mg as tmg

DX = (0.1, 0.12)
TOL = 1e-12
BV = [[0.2, -0.3], [0.15, 0.4]]


def _close(out, ref, what):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    err = float(np.max(np.abs(out - ref)))
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def _problem(n, ell_bc, seed):
    rng = np.random.RandomState(seed)
    beta = [0.5 + rng.rand(*[n[t] + (1 if t == d else 0) for t in range(2)])
            for d in range(2)]
    phi = rng.rand(*n) - 0.5
    rhs = rng.rand(*n) - 0.5
    jl = jmg.make_level(n, DX, ell_bc, jnp.zeros(n),
                        tuple(jnp.asarray(b) for b in beta), 0.0)
    diag = np.asarray(jl.diag)
    inv = np.where(diag != 0.0, 1.0 / np.where(diag == 0.0, 1.0, diag), 0.0)
    targs = (torch.as_tensor(phi), torch.as_tensor(rhs), torch.as_tensor(inv),
             tuple(torch.as_tensor(b) for b in beta), DX, ell_bc, BV)
    return rng, jl, phi, rhs, targs


@pytest.mark.parametrize("n,ell_bc,corr_fac", [
    ((16, 16), [(1, 2), (2, 1)], (2, 2)),
    ((16, 16), [(0, 0), (3, 3)], (1, 2)),
    ((16, 16), [(2, 3), (0, 0)], (2, 1)),
    ((15, 9), [(3, 1), (2, 2)], None),
])
def test_gsrb2d_fused_stages_match_varden_tpu(n, ell_bc, corr_fac):
    rng, jl, phi, rhs, targs = _problem(n, ell_bc, sum(n))
    sweeps = jax.jit(lambda p, r: jmg.gsrb(jl, p, r, BV, 2))
    if corr_fac is not None:
        c = rng.rand(*[s // f for s, f in zip(n, corr_fac)]) - 0.5
        cf = c
        for d, f in enumerate(corr_fac):
            cf = np.repeat(cf, f, axis=d)
        ref = sweeps(jnp.asarray(phi + cf), jnp.asarray(rhs))
        out = tck.gsrb_sweep_2d(*targs, emit="smooth", nsweeps=2,
                                corr=torch.as_tensor(c), cfac=corr_fac)
        _close(out, ref, f"smooth+corr {corr_fac}")
    ref_phi = sweeps(jnp.asarray(phi), jnp.asarray(rhs))
    out = tck.gsrb_sweep_2d(*targs, emit="smooth", nsweeps=2)
    _close(out, ref_phi, "smooth")
    if any(s % 2 for s in n):
        return
    p, crs, rmax = tck.gsrb_sweep_2d(*targs, emit="smooth_restrict",
                                     nsweeps=2)
    _close(p, ref_phi, "smooth_restrict phi")
    r = jax.jit(lambda q: jnp.asarray(rhs) - jmg.cc_apply(jl, q, BV))(ref_phi)
    _close(crs, jmg._cell_avg_down(r, 2), "smooth_restrict coarse residual")
    _close(rmax, jnp.max(jnp.abs(r)), "smooth_restrict max|r|")


@pytest.mark.parametrize("n,ell_bc", [
    ((32, 32), [(1, 1), (1, 1)]),
    ((32, 24), [(0, 0), (2, 1)]),
    ((30, 16), [(2, 2), (0, 0)]),
])
def test_gsrb2d_fused_route_is_the_single_pass_composition(n, ell_bc,
                                                           monkeypatch):
    """mg.v_cycle visits a 2-D face-tensor level through kernel 8's fused
    stages: on the CPU the route and the single passes compute the same
    plain composition, bit for bit, and so does a solve (phi, cycles and
    ratio), odd coarse extents (30 x 16 coarsens to 15 x 8) included."""
    rng = np.random.RandomState(9)
    beta = tuple(torch.as_tensor(0.5 + rng.rand(
        *[n[t] + (1 if t == d else 0) for t in range(2)])) for d in range(2))
    rhs = torch.as_tensor(smooth(n, 3, amp=2.0, dm=2))
    phi0 = torch.as_tensor(rng.rand(*n) - 0.5)
    aco = torch.zeros(n, dtype=torch.float64)
    levels = tmg.build_hierarchy(list(n), list(DX), ell_bc, aco, beta, 0.0)
    assert all(tmg._fused_route(lv, phi0[:lv.n[0], :lv.n[1]])
               for lv in levels)
    outs = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(tmg, "_fused_route", lambda lv, p: False)
        p, mon = tmg.v_cycle(levels, phi0, rhs, BV, return_resnorm=True)
        sol, (rn, cycles, ratio) = tmg.solve(
            n, DX, ell_bc, aco, beta, rhs, bvals=BV, rel_eps=1e-10,
            return_info=True)
        assert cycles > 0
        outs.append((p, mon, sol, rn, ratio, torch.tensor(cycles)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("emit", ["smooth", "smooth_restrict"])
def test_gsrb2d_fused_stages_refuse_no_sweep(emit):
    """A fused stage runs at least one sweep, on the CPU as on the card."""
    z = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="nsweeps"):
        tck.gsrb_sweep_2d(z, z, z, (torch.zeros(5, 4), torch.zeros(4, 5)),
                          DX, [(1, 1)] * 2, BV, emit=emit, nsweeps=0)


def test_gsrb2d_smooth_restrict_refuses_odd_extents():
    """The restriction halves every axis: smooth_restrict takes even
    extents only ("smooth" takes any)."""
    z = torch.zeros((5, 4), dtype=torch.float64)
    beta = (torch.ones(6, 4, dtype=torch.float64),
            torch.ones(5, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="even extents"):
        tck.gsrb_sweep_2d(z, z, z, beta, DX, [(1, 1)] * 2, BV,
                          emit="smooth_restrict", nsweeps=2)
    out = tck.gsrb_sweep_2d(z, z, z, beta, DX, [(1, 1)] * 2, BV,
                            emit="smooth", nsweeps=2)
    assert out.shape == (5, 4)
