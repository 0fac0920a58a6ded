"""The fused multigrid stages of kernels 3, 4 and 5 (their plain versions
on CPU tensors, which the V-cycles run on the CPU) against varden_tpu
composed the same way, at 16^3 in float64:

  kernel 3 "smooth" / "smooth_restrict": phi + the piecewise-constant
    prolongation of a coarse correction, nsweeps exact red-black sweeps
    (varden_tpu's mg.gsrb: the Pallas sweep is a tiled hybrid whose
    tile-edge neighbours keep their pre-sweep values, by design), then the
    residual's 2x2x2 restriction and max|r| through varden_tpu's Pallas
    gsrb_var_sweep_3d in interpret mode (or, on a periodic x axis, which
    that kernel does not take, its plain residual and cell average);
  kernel 4 "smooth" / "smooth_restrict": phi + varden_tpu's linear
    prolongation of a coarse correction, nsweeps Jacobi passes and the
    residual through varden_tpu's Pallas nodal_sweep_3d in interpret mode
    (padded as varden_tpu pads), then its P^T restriction;
  kernel 5 "smooth" / "smooth_restrict" on a batch of B = 1 or 3 fields:
    phi + the piecewise-constant prolongation of a coarse correction,
    nsweeps exact red-black sweeps (varden_tpu's mg.gsrb on a scalar-beta
    level), then the residual through varden_tpu's Pallas
    gsrb_const_sweep_3d in interpret mode (or, on a periodic x axis, which
    that kernel does not take, its plain residual), its cell average and
    max|r| over the whole batch.

Every elliptic BC code (periodic 0, Neumann 1, Dirichlet 2 with non-zero
face values, coarse-fine ghost 3), a periodic axis and an odd extent where
the emit takes one. Tolerance: 1e-12 of each field's largest value (the
same arithmetic, summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varden_tpu.ops import pallas_kernels as jpk
from varden_tpu.solvers import mg as jmg
from varden_tpu.solvers import nodal as jnd
from varden_tpu_torch.ops import cuda_kernels as tck
from varden_tpu_torch.solvers import mg as tmg

DX = (0.1, 0.11, 0.12)
TOL = 1e-12


def _close(out, ref, what):
    out = out.numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    err = float(np.max(np.abs(out - ref)))
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


@pytest.mark.parametrize("n,ell_bc,corr_fac", [
    ((16, 16, 16), [(1, 2), (2, 1), (3, 3)], (2, 2, 2)),
    ((16, 16, 16), [(2, 2), (0, 0), (1, 3)], (1, 2, 2)),
    ((16, 16, 16), [(0, 0), (3, 1), (2, 0)], (2, 2, 2)),
    ((15, 16, 9), [(2, 1), (1, 3), (0, 0)], None),
])
def test_gsrb_var_fused_stages_match_varden_tpu(n, ell_bc, corr_fac):
    rng = np.random.RandomState(sum(n))
    beta = [0.5 + rng.rand(*[n[t] + (1 if t == d else 0) for t in range(3)])
            for d in range(3)]
    phi = rng.rand(*n) - 0.5
    rhs = rng.rand(*n) - 0.5
    bv = [[0.2, 0.3], [0.15, -0.1], [0.05, 0.4]]
    jl = jmg.make_level(n, DX, ell_bc, jnp.zeros(n),
                        tuple(jnp.asarray(b) for b in beta), 0.0)
    diag = np.asarray(jl.diag)
    inv = np.where(diag != 0.0, 1.0 / np.where(diag == 0.0, 1.0, diag), 0.0)
    targs = (torch.as_tensor(phi), torch.as_tensor(rhs), torch.as_tensor(inv),
             tuple(torch.as_tensor(b) for b in beta), DX, ell_bc, bv)
    sweeps = jax.jit(lambda p, r: jmg.gsrb(jl, p, r, bv, 2))
    # smooth with a coarse correction: phi + its piecewise-constant copy
    if corr_fac is not None:
        c = rng.rand(*[s // f for s, f in zip(n, corr_fac)]) - 0.5
        cf = c
        for d, f in enumerate(corr_fac):
            cf = np.repeat(cf, f, axis=d)
        ref = sweeps(jnp.asarray(phi + cf), jnp.asarray(rhs))
        out = tck.gsrb_var_sweep_3d(*targs, emit="smooth", nsweeps=2,
                                    corr=torch.as_tensor(c), cfac=corr_fac)
        _close(out, ref, f"smooth+corr {corr_fac}")
    ref_phi = sweeps(jnp.asarray(phi), jnp.asarray(rhs))
    out = tck.gsrb_var_sweep_3d(*targs, emit="smooth", nsweeps=2)
    _close(out, ref_phi, "smooth")
    if any(s % 2 for s in n):
        return
    p, crs, rmax = tck.gsrb_var_sweep_3d(*targs, emit="smooth_restrict",
                                         nsweeps=2)
    _close(p, ref_phi, "smooth_restrict phi")
    if ell_bc[0][0] == 0:  # the Pallas kernel takes no periodic x axis
        r = jnp.asarray(rhs) - jmg.cc_apply(jl, ref_phi, bv)
        c_ref, m_ref = jmg._cell_avg_down(r, 3), jnp.max(jnp.abs(r))
    else:
        c_ref, m_ref = jpk.gsrb_var_sweep_3d(
            ref_phi, jnp.asarray(rhs), jnp.asarray(inv),
            tuple(jnp.asarray(b) for b in beta), DX, ell_bc, bv,
            emit="restrict", interpret=True)
    _close(crs, c_ref, "smooth_restrict coarse residual")
    _close(rmax, m_ref, "smooth_restrict max|r|")


@pytest.mark.parametrize("n,pmask", [
    ((16, 16, 16), (False, False, False)),
    ((16, 16, 16), (True, False, True)),
    ((15, 16, 9), (False, True, False)),
])
def test_nodal_fused_stages_match_varden_tpu(n, pmask):
    rng = np.random.RandomState(sum(n) + 1)
    ns = tuple(s if p else s + 1 for s, p in zip(n, pmask))
    sigma = rng.rand(*n) + 0.5
    phi = rng.rand(*ns) - 0.5
    rhs = rng.rand(*ns) - 0.5
    inv = 1.0 / np.asarray(jnd.node_diag(jnp.asarray(sigma), DX, pmask, 3))
    jsig = jnd._sigma_np(jnp.asarray(sigma), pmask, 3)

    def passes(p, nsweeps):
        for _ in range(nsweeps):
            p = jpk.nodal_sweep_3d(jnd._pad_node(p, pmask, 3), jsig,
                                   jnp.asarray(rhs), jnp.asarray(inv), DX,
                                   emit="jacobi", interpret=True)
        return p

    targs = (torch.as_tensor(phi), torch.as_tensor(sigma),
             torch.as_tensor(rhs), torch.as_tensor(inv), DX, 0.85)
    ref_phi = passes(jnp.asarray(phi), 2)
    out = tck.nodal_sweep_3d(*targs, "smooth", pmask=pmask, nsweeps=2)
    _close(out, ref_phi, "smooth")
    if any(s % 2 for s in n):
        return
    cn = tuple(s // 2 if p else s // 2 + 1 for s, p in zip(n, pmask))
    c = rng.rand(*cn) - 0.5
    ref = passes(jnp.asarray(phi) + jnd._prolong(jnp.asarray(c), ns, pmask,
                                                 3), 2)
    out = tck.nodal_sweep_3d(*targs, "smooth", pmask=pmask, nsweeps=2,
                             corr=torch.as_tensor(c))
    _close(out, ref, "smooth+corr")
    p, crs, rmax = tck.nodal_sweep_3d(*targs, "smooth_restrict", pmask=pmask,
                                      nsweeps=2)
    _close(p, ref_phi, "smooth_restrict phi")
    r = jpk.nodal_sweep_3d(jnd._pad_node(ref_phi, pmask, 3), jsig,
                           jnp.asarray(rhs), jnp.asarray(inv), DX,
                           emit="residual", interpret=True)
    _close(crs, jnd._restrict(r, pmask, 3), "smooth_restrict coarse rhs")
    _close(rmax, jnp.max(jnp.abs(r)), "smooth_restrict max|r|")


@pytest.mark.parametrize("n,ell_bc,B,alpha,corr_fac", [
    ((16, 16, 16), [(2, 2), (2, 2), (2, 2)], 3, 1.0, (2, 2, 2)),
    ((16, 16, 16), [(1, 2), (2, 1), (3, 3)], 1, 1.0, (1, 2, 2)),
    ((16, 16, 16), [(0, 0), (3, 1), (1, 2)], 3, 1.0, (2, 2, 2)),
    ((16, 16, 16), [(2, 2), (0, 0), (1, 3)], 1, 0.0, (2, 1, 2)),
    ((15, 16, 9), [(2, 1), (1, 3), (0, 0)], 3, 1.0, None),
])
def test_gsrb_const_fused_stages_match_varden_tpu(n, ell_bc, B, alpha,
                                                  corr_fac):
    rng = np.random.RandomState(sum(n) + B)
    beta = (0.03, 0.04, 0.05)
    aco = 1.0 + 9.0 * rng.rand(*n)
    phi = rng.rand(B, *n) - 0.5
    rhs = rng.rand(B, *n) - 0.5
    bv = [[0.2, 0.3], [0.15, -0.1], [0.05, 0.4]]
    jl = jmg.make_level(n, DX, ell_bc, jnp.asarray(aco), beta, alpha)
    diag = np.asarray(jl.diag)
    inv = np.where(diag != 0.0, 1.0 / np.where(diag == 0.0, 1.0, diag), 0.0)
    coef = [beta[d] / DX[d] ** 2 for d in range(3)] + [alpha]
    taco = torch.as_tensor(aco) if alpha else None
    targs = (torch.as_tensor(phi), torch.as_tensor(rhs), torch.as_tensor(inv),
             coef, ell_bc, bv)
    sweeps = jax.jit(lambda p, r: jmg.gsrb(jl, p, r, bv, 2))
    if corr_fac is not None:
        c = rng.rand(B, *[s // f for s, f in zip(n, corr_fac)]) - 0.5
        cf = c
        for d, f in enumerate(corr_fac):
            cf = np.repeat(cf, f, axis=d + 1)
        ref = sweeps(jnp.asarray(phi + cf), jnp.asarray(rhs))
        out = tck.gsrb_const_sweep_3d(*targs, aco=taco, emit="smooth",
                                      nsweeps=2, corr=torch.as_tensor(c),
                                      cfac=corr_fac)
        _close(out, ref, f"smooth+corr {corr_fac}")
    ref_phi = sweeps(jnp.asarray(phi), jnp.asarray(rhs))
    out = tck.gsrb_const_sweep_3d(*targs, aco=taco, emit="smooth", nsweeps=2)
    _close(out, ref_phi, "smooth")
    if any(s % 2 for s in n):
        return
    p, crs, rmax = tck.gsrb_const_sweep_3d(*targs, aco=taco,
                                           emit="smooth_restrict", nsweeps=2)
    _close(p, ref_phi, "smooth_restrict phi")
    if ell_bc[0][0] == 0:  # the Pallas kernel takes no periodic x axis
        r = jnp.asarray(rhs) - jmg.cc_apply(jl, ref_phi, bv)
    else:
        r = jpk.gsrb_const_sweep_3d(
            ref_phi, jnp.asarray(rhs), jnp.asarray(inv), jnp.asarray(coef),
            ell_bc, bv, aco=jnp.asarray(aco) if alpha else None,
            emit="residual", interpret=True)
    _close(crs, jmg._cell_avg_down(r, 3), "smooth_restrict coarse residual")
    _close(rmax, jnp.max(jnp.abs(r)), "smooth_restrict max|r| (batch)")


@pytest.mark.parametrize("n,ell_bc,alpha,batched", [
    ((16, 16, 12), [(2, 2), (1, 2), (0, 0)], 1.0, True),
    ((16, 8, 16), [(1, 1), (3, 3), (2, 2)], 1.0, False),
    ((12, 16, 16), [(0, 0), (0, 0), (1, 1)], 0.0, True),
])
def test_const_fused_route_is_the_single_pass_composition(n, ell_bc, alpha,
                                                          batched):
    """mg.v_cycle visits the scalar-beta levels of at most
    CONST_FUSED_MAX_CELLS cells through kernel 5's fused stages: on the CPU
    the two routes compute the same plain composition, bit for bit, with
    the batch axis and without, and so does a solve."""
    rng = np.random.RandomState(5)
    dx = (0.1, 0.11, 0.12)
    aco = torch.as_tensor(1.0 + rng.rand(*n))
    shape = ((3,) if batched else ()) + n
    rhs = torch.as_tensor(rng.rand(*shape) - 0.5)
    phi0 = torch.as_tensor(rng.rand(*shape) - 0.5)
    bv = [[0.2, 0.3], [0.1, -0.1], [0.0, 0.4]]
    beta = [0.5, 0.4, 0.3]
    levels = tmg.build_hierarchy(list(n), list(dx), ell_bc, aco, beta, alpha)
    saved = tmg.CONST_FUSED_MAX_CELLS
    outs = []
    try:
        for ceiling in (0, 2 ** 62):
            tmg.CONST_FUSED_MAX_CELLS = ceiling
            p, mon = tmg.v_cycle(levels, phi0, rhs, bv, return_resnorm=True)
            sol, (rn, cycles, _) = tmg.solve(
                n, dx, ell_bc, aco, beta, rhs, alpha=alpha, bvals=bv,
                max_cycles=3, return_info=True)
            outs.append((p, mon, sol, rn, torch.tensor(cycles)))
    finally:
        tmg.CONST_FUSED_MAX_CELLS = saved
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["gsrb_var", "nodal", "gsrb_const"])
@pytest.mark.parametrize("emit", ["smooth", "smooth_restrict"])
def test_fused_stages_refuse_no_sweep(kernel, emit):
    """A fused stage runs at least one sweep: nsweeps 0 is refused, on the
    CPU as on the card."""
    z = torch.zeros((4, 4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="nsweeps"):
        if kernel == "gsrb_var":
            tck.gsrb_var_sweep_3d(z, z, z, (z,) * 3, DX, [(1, 1)] * 3,
                                  [[0.0, 0.0]] * 3, emit=emit, nsweeps=0)
        elif kernel == "gsrb_const":
            tck.gsrb_const_sweep_3d(z[None], z[None], z, [1.0] * 4,
                                    [(1, 1)] * 3, [[0.0, 0.0]] * 3,
                                    emit=emit, nsweeps=0)
        else:
            tck.nodal_sweep_3d(z, z, z, z, DX, 0.85, emit,
                               pmask=(True,) * 3, nsweeps=0)
