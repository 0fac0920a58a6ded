"""The fused multigrid stages of kernel 7, gsrb_sweep_3d's "smooth" and
"smooth_restrict" (their plain versions on CPU tensors, which the V-cycles
of periodic-x levels run on the CPU), against varden_tpu composed as its
accelerator route runs them, in float64:

  "smooth": phi + the piecewise-constant prolongation of a coarse
    correction, then nu times varden_tpu's mg._pad_ghost and its TPU kernel
    pallas_kernels.gsrb_sweep_3d (interpret mode): each sweep's ghost ring
    held at the sweep's start;
  "smooth_restrict": nu such sweeps, then the residual rhs - cc_apply(phi)
    (a fresh ring), its 2x2x2 average (mg._cell_avg_down) and max|r|.

x is periodic; y and z are each periodic, Neumann, Dirichlet with non-zero
face values or coarse-fine ghost (the cases of test_torch_gsrb_padded.py),
nu 1-3, cfac (2, 2, 2), (2, 1, 2) and (2, 2, 1), alpha on and off.
Tolerance: 1e-12 of each output's largest value (the same arithmetic; the
residual is summed in another order). mg.v_cycle and mg.solve on a
periodic-x hierarchy, config 4's boundaries and a fully periodic (vortex
tube) one, give through the fused stages what the ghost pad, the padded
sweep and kernel 3's restriction gave before them, bit for bit, and call
mg._pad_ghost no more."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gsrb_padded import BV, DX, SWEEP_CASES, _problem
from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import ref_jit, smooth

from varden_tpu.ops import pallas_kernels as jpk
from varden_tpu.solvers import mg as jmg
from varden_tpu_torch.ops import cuda_kernels as tck
from varden_tpu_torch.solvers import mg as tmg

TOL = 1e-12
# (sweeps, cfac of the coarse correction) for each case of SWEEP_CASES
STAGES = [(1, (2, 2, 2)), (2, (2, 1, 2)), (3, (2, 2, 1)), (2, (2, 2, 2)),
          (1, (2, 2, 2)), (3, (1, 2, 2))]


def _close(out, ref, what):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    err = float(np.max(np.abs(out - ref)))
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


@pytest.mark.parametrize("case,stage", list(zip(SWEEP_CASES, STAGES)))
def test_fused_stages_match_the_accelerator_route(case, stage):
    n, ell_bc, alpha = case
    nu, cfac = stage
    jl, tl, phi, rhs = _problem(n, ell_bc, alpha)
    inv = tl.inv_diag.numpy()
    sweep = ref_jit(lambda p, r: jpk.gsrb_sweep_3d(
        jmg._pad_ghost(p, ell_bc, BV, 3), r, jnp.asarray(inv), list(jl.beta),
        DX, aco=jl.aco, alpha=alpha, interpret=True))

    def sweeps(p):
        p = jnp.asarray(p)
        for _ in range(nu):
            p = sweep(p, jnp.asarray(rhs))
        return p

    targs = (torch.as_tensor(phi), torch.as_tensor(rhs), tl.inv_diag,
             tl.beta, DX)
    tkw = dict(aco=tl.aco, alpha=alpha, ell_bc=ell_bc, bvals=BV, nsweeps=nu)
    rng = np.random.RandomState(sum(n))
    c = rng.rand(*[s // f for s, f in zip(n, cfac)]) - 0.5
    cf = c
    for d, f in enumerate(cfac):
        cf = np.repeat(cf, f, axis=d)
    out = tck.gsrb_sweep_3d(*targs, emit="smooth", corr=torch.as_tensor(c),
                            cfac=cfac, **tkw)
    _close(out, sweeps(phi + cf), f"smooth+corr {cfac}")
    ref = sweeps(phi)
    p, crs, rmax = tck.gsrb_sweep_3d(*targs, emit="smooth_restrict", **tkw)
    _close(p, ref, "smooth_restrict phi")
    r = ref_jit(lambda q: jnp.asarray(rhs) - jmg.cc_apply(jl, q, BV))(ref)
    _close(crs, jmg._cell_avg_down(r, 3), "smooth_restrict coarse residual")
    _close(rmax, jnp.max(jnp.abs(r)), "smooth_restrict max|r|")


def _single_passes(level, phi, rhs, bvals, emit, nsweeps, corr=None,
                   cfac=(2, 2, 2)):
    """What a V-cycle ran on a padded-route level before the fused stages:
    the ghost pad and the padded sweep nsweeps times, then kernel 3's
    restrict emit."""
    if corr is not None:
        phi = phi + tck.cell_prolong(corr, cfac)
    aco = level.aco if level.alpha != 0.0 else None
    for _ in range(nsweeps):
        pad = tmg._pad_ghost(phi, level.ell_bc, bvals, 3)
        phi = tck.gsrb_sweep_3d(pad, rhs, level.inv_diag, level.beta,
                                level.dx, aco=aco, alpha=level.alpha)
    if emit == "smooth":
        return phi
    return (phi, *tmg._var_sweep(level, phi, rhs, bvals, "restrict"))


@pytest.mark.parametrize("n,ell_bc", [
    ((32, 16, 16), [(0, 0), (0, 0), (2, 2)]),
    ((16, 16, 16), [(0, 0), (0, 0), (0, 0)]),
])
def test_padded_route_is_the_single_pass_composition(n, ell_bc, monkeypatch):
    """config 4's boundaries (periodic x and y, here Dirichlet z with
    non-zero values) and the vortex tube's (fully periodic, singular):
    the V-cycles and solves through kernel 7's fused stages, and through
    the single passes they replace (_single_passes)."""
    rng = np.random.RandomState(4)
    beta = tuple(torch.as_tensor(0.5 + rng.rand(
        *[n[t] + (1 if t == d else 0) for t in range(3)])) for d in range(3))
    rhs = torch.as_tensor(smooth(n, 6, amp=5.0))
    bv = BV if 2 in ell_bc[2] else [[0.0, 0.0]] * 3
    singular = tmg.is_singular(ell_bc, 0.0)
    if singular:
        rhs = rhs - rhs.mean()
    phi0 = torch.as_tensor(rng.rand(*n) - 0.5)
    aco = torch.zeros(n, dtype=torch.float64)
    levels = tmg.build_hierarchy(list(n), list(DX), ell_bc, aco, beta, 0.0)
    assert sum(tmg._padded_route(lv, torch.zeros(lv.n)) for lv in levels) >= 2
    pads = []
    pad_ghost = tmg._pad_ghost
    monkeypatch.setattr(tmg, "_pad_ghost",
                        lambda *a: pads.append(1) or pad_ghost(*a))
    outs = []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(tmg, "_padded_sweep", _single_passes)
        pads.clear()
        p, mon = tmg.v_cycle(levels, phi0, rhs, bv, singular=singular,
                             return_resnorm=True)
        # the fused stages form the ring themselves
        assert bool(pads) is not fused
        sol, (rn, cycles, ratio) = tmg.solve(
            n, DX, ell_bc, aco, beta, rhs, bvals=bv, rel_eps=1e-10,
            return_info=True)
        assert cycles > 0
        outs.append((p, mon, sol, rn, ratio, torch.tensor(cycles)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("emit", ["smooth", "smooth_restrict"])
def test_fused_stages_refuse_no_sweep(emit):
    """A fused stage runs at least one sweep, on the CPU as on the card."""
    n = (8, 8, 8)
    _jl, tl, phi, rhs = _problem(n, SWEEP_CASES[0][1], 0.0)
    with pytest.raises(ValueError, match="nsweeps"):
        tck.gsrb_sweep_3d(torch.as_tensor(phi), torch.as_tensor(rhs),
                          tl.inv_diag, tl.beta, DX, emit=emit,
                          ell_bc=SWEEP_CASES[0][1], bvals=BV, nsweeps=0)


def test_smooth_restrict_refuses_odd_extents():
    """The restriction halves every axis: smooth_restrict takes even
    extents only ("smooth" takes any)."""
    n, ell_bc = (9, 8, 7), [(0, 0), (2, 2), (0, 0)]
    _jl, tl, phi, rhs = _problem(n, ell_bc, 0.0)
    args = (torch.as_tensor(phi), torch.as_tensor(rhs), tl.inv_diag,
            tl.beta, DX)
    with pytest.raises(ValueError, match="even extents"):
        tck.gsrb_sweep_3d(*args, emit="smooth_restrict", ell_bc=ell_bc,
                          bvals=BV, nsweeps=2)
    out = tck.gsrb_sweep_3d(*args, emit="smooth", ell_bc=ell_bc, bvals=BV,
                            nsweeps=2)
    assert out.shape == n
