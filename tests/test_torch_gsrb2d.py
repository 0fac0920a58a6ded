"""The port's 2-D solvers against varden_tpu on the same inputs (float64,
CPU): the gsrb_sweep_2d wrapper (its plain version on CPU tensors), the
cell-centred multigrid (face-tensor beta; scalar beta on the Jacobi fast
path and on the V-cycle branch, batched and not), mg.laplacian, the nodal
solver, both projections and the viscous and diffusive solves.

Tolerances: 1e-11 for operator applications and sweeps (the same
arithmetic, summed in another order); 1e-9 relative for solves (both run
the same cycles to their rel_eps). In 2-D varden_tpu smooths the scalar-beta
fast path with Jacobi on every backend and so does the port, so the two
agree there to roundoff (1e-11), not to the solver's tolerance.

The TPU kernel pk.gsrb_sweep_2d keeps the ghosts it was given through both
colours, so its black cells on a Dirichlet or periodic boundary row see
stale ghosts; the port's sweep is exact there. The two are compared on the
cells no ghost reaches (one or more cells from every boundary)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import ref_jit, smooth

from varden_tpu import projection as jproj
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.ops import pallas_kernels as jpk
from varden_tpu.solvers import mg as jmg
from varden_tpu.solvers import nodal as jnd
from varden_tpu.state import Sim as JSim
from varden_tpu_torch import projection as tproj
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.ops import cuda_kernels as tck
from varden_tpu_torch.solvers import mg as tmg
from varden_tpu_torch.solvers import nodal as tnd
from varden_tpu_torch.state import Sim as TSim

DX = (0.1, 0.12)
CASES = [
    ((16, 16), [(2, 1), (0, 0)]),
    ((16, 24), [(1, 1), (1, 1)]),
    ((15, 9), [(0, 0), (2, 2)]),
    ((8, 6), [(1, 2), (3, 1)]),
]
BV = [[0.2, -0.3], [0.15, 0.4]]


def _err(t, j):
    return float(np.max(np.abs(t.numpy() - np.asarray(j))))


def _problem(n, ell_bc, alpha=0.0, seed=7):
    rng = np.random.RandomState(seed)
    beta = [0.5 + rng.rand(*[n[t] + (1 if t == d else 0) for t in range(2)])
            for d in range(2)]
    aco = 1.0 + rng.rand(*n)
    phi = rng.rand(*n) - 0.5
    rhs = rng.rand(*n) - 0.5
    jl = jmg.make_level(n, DX, ell_bc, jnp.asarray(aco),
                        tuple(jnp.asarray(b) for b in beta), alpha)
    tl = tmg.make_level(n, DX, ell_bc, torch.as_tensor(aco),
                        tuple(torch.as_tensor(b) for b in beta), alpha)
    return jl, tl, phi, rhs


@pytest.mark.parametrize("alpha", [0.0, 0.7])
@pytest.mark.parametrize("n,ell_bc", CASES)
def test_gsrb_sweep_2d_matches_mg_gsrb(n, ell_bc, alpha):
    jl, tl, phi, rhs = _problem(n, ell_bc, alpha)
    tp, tr = torch.as_tensor(phi), torch.as_tensor(rhs)
    assert _err(tl.diag, jl.diag) < 1e-11
    ref = jmg.cc_apply(jl, jnp.asarray(phi), BV)
    assert _err(tmg.cc_apply(tl, tp, BV), ref) < 1e-11
    args = (tp, tr, tl.inv_diag, tl.beta, DX, ell_bc, BV)
    res = tck.gsrb_sweep_2d(*args, aco=tl.aco, alpha=alpha, emit="residual")
    assert _err(res, jnp.asarray(rhs) - ref) < 1e-11
    assert _err(tmg._residual(tl, tp, tr, BV), jnp.asarray(rhs) - ref) < 1e-11
    one = tck.gsrb_sweep_2d(*args, aco=tl.aco, alpha=alpha)
    assert _err(one, jmg.gsrb(jl, jnp.asarray(phi), jnp.asarray(rhs), BV,
                              1)) < 1e-11
    ref3 = ref_jit(lambda p, r: jmg.gsrb(jl, p, r, BV, 3))(
        jnp.asarray(phi), jnp.asarray(rhs))
    assert _err(tmg.gsrb(tl, tp, tr, BV, 3), ref3) < 1e-11


@pytest.mark.parametrize("alpha", [0.0, 0.7])
@pytest.mark.parametrize("n,ell_bc", CASES[:2])
def test_gsrb_sweep_2d_matches_the_tpu_kernel_off_the_boundary(n, ell_bc,
                                                               alpha):
    jl, tl, phi, rhs = _problem(n, ell_bc, alpha, seed=3)
    pad = jmg._pad_ghost(jnp.asarray(phi), jl.ell_bc, BV, 2)
    ker = jpk.gsrb_sweep_2d(pad, jnp.asarray(rhs), 1.0 / jl.diag, jl.beta, DX,
                            aco=jl.aco, alpha=alpha, interpret=True)
    out = tck.gsrb_sweep_2d(torch.as_tensor(phi), torch.as_tensor(rhs),
                            tl.inv_diag, tl.beta, DX, ell_bc, BV, aco=tl.aco,
                            alpha=alpha)
    assert _err(out[1:-1, 1:-1], ker[1:-1, 1:-1]) < 1e-11
    red = (np.add.outer(np.arange(n[0]), np.arange(n[1])) % 2) == 0
    assert _err(out[torch.as_tensor(red)], np.asarray(ker)[red]) < 1e-11


def test_gsrb_sweep_2d_rejects_bad_arguments():
    jl, tl, phi, rhs = _problem((8, 6), [(1, 1), (1, 1)])
    tp, tr = torch.as_tensor(phi), torch.as_tensor(rhs)
    with pytest.raises(ValueError, match="emit"):
        tck.gsrb_sweep_2d(tp, tr, tl.inv_diag, tl.beta, DX, tl.ell_bc, BV,
                          emit="restrict")
    with pytest.raises(ValueError, match="2-D"):
        tck.gsrb_sweep_2d(tp[None], tr, tl.inv_diag, tl.beta, DX, tl.ell_bc,
                          BV)


def _mac_beta(n, ell_bc, seed=5):
    """Face coefficients 2/(rho_lo + rho_hi) of a random density whose
    ghosts wrap on periodic axes (one coefficient per periodic face)."""
    rng = np.random.RandomState(seed)
    rho = np.pad(1.0 + rng.rand(*n), 1, mode="edge")
    for d in range(2):
        if ell_bc[d][0] == 0:
            rho = np.moveaxis(rho, d, 0)
            rho[0], rho[-1] = rho[-2].copy(), rho[1].copy()
            rho = np.moveaxis(rho, 0, d)
    beta = []
    for d in range(2):
        q = rho[tuple(slice(1, -1) if t != d else slice(None)
                      for t in range(2))]
        beta.append(2.0 / (q[tuple(slice(1, None) if t == d else slice(None)
                                   for t in range(2))]
                           + q[tuple(slice(0, -1) if t == d else slice(None)
                                     for t in range(2))]))
    return beta


@pytest.mark.parametrize("bottom", ["dense", "cg"])
@pytest.mark.parametrize("n,ell_bc", [
    ((32, 32), [(1, 1), (1, 1)]), ((32, 32), [(0, 0), (1, 1)]),
    ((16, 32), [(2, 1), (1, 2)])])
def test_solve_2d_on_a_mac_operator(n, ell_bc, bottom):
    beta = _mac_beta(n, ell_bc)
    rhs = smooth(n, 6, amp=2.0, dm=2)
    dx = (1.0 / 32, 1.0 / 32)
    kw = dict(alpha=0.0, rel_eps=1e-10, abs_eps=-1.0, return_info=True,
              bottom=bottom)
    pj, (rn_j, it_j, _) = ref_jit(lambda b, r: jmg.solve(
        n, dx, ell_bc, jnp.zeros(n), b, r, **kw))(
        tuple(jnp.asarray(b) for b in beta), jnp.asarray(rhs))
    pt, (rn_t, it_t, ratio) = tmg.solve(
        n, dx, ell_bc, torch.zeros(n, dtype=torch.float64),
        tuple(torch.as_tensor(b) for b in beta), torch.as_tensor(rhs), **kw)
    assert int(it_t) == int(it_j) > 0
    assert float(ratio) <= 1.0
    scale = float(np.max(np.abs(np.asarray(pj))))
    assert _err(pt, pj) < (1e-9 if bottom == "dense" else 1e-8) * scale


N = (32, 32)
DXH = (1.0 / 32,) * 2
MU_FAST, MU_MG = 1e-5, 0.02    # gamma about 0.04 and about 0.99
HELM_BCS = {
    "walls": ([(2, 2)] * 2, [[0.0, 0.0]] * 2),
    "mixed": ([(0, 0), (1, 2)], [[0.0, 0.0], [0.0, 0.3]]),
}


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("mu", [MU_FAST, MU_MG])
@pytest.mark.parametrize("bc", sorted(HELM_BCS))
def test_helmholtz_solve_2d_matches(bc, mu, batched):
    ell_bc, bvals = HELM_BCS[bc]
    aco = 1.0 + 0.5 * (1.0 + smooth(N, 1, amp=1.0, dm=2))
    shape = (2,) + N if batched else N
    rhs = smooth(shape, 2, amp=2.0, dm=2)
    phi0 = smooth(shape, 3, amp=0.5, dm=2)
    kw = dict(alpha=1.0, bvals=bvals, rel_eps=1e-12, abs_eps=-1.0,
              return_info=True)
    pj, (rn_j, it_j, ratio_j) = ref_jit(lambda a, r, p: jmg.solve(
        N, DXH, ell_bc, a, (mu,) * 2, r, phi0=p, **kw))(
        jnp.asarray(aco), jnp.asarray(rhs), jnp.asarray(phi0))
    pt, (rn_t, it_t, ratio_t) = tmg.solve(
        N, DXH, ell_bc, torch.as_tensor(aco), (mu,) * 2, torch.as_tensor(rhs),
        phi0=torch.as_tensor(phi0), **kw)
    assert float(ratio_t) <= 1.0 and float(ratio_j) <= 1.0
    if mu == MU_FAST:
        assert it_t == 0 and int(it_j) == 0      # Jacobi sweeps settled it
    else:
        assert it_t == int(it_j) > 0             # the same V-cycles
    # roundoff, not the solver tolerance: the same smoother in both
    assert _err(pt, pj) <= 1e-11 * float(np.max(np.abs(np.asarray(pj))))


def test_fast_path_2d_runs_jacobi_not_red_black():
    """One Jacobi sweep differs from one red-black sweep at first order, so
    a solve cut to its fast path tells the two apart."""
    ell_bc, bvals = HELM_BCS["walls"]
    aco = torch.ones(N, dtype=torch.float64)
    rhs = torch.as_tensor(smooth(N, 4, dm=2))
    lev = tmg.make_level(N, DXH, ell_bc, aco, (MU_FAST,) * 2, 1.0)
    j1 = tmg.jacobi(lev, torch.zeros_like(rhs), rhs, bvals, 1)
    g1 = tmg.gsrb(lev, torch.zeros_like(rhs), rhs, bvals, 1)
    jl = jmg.make_level(N, DXH, ell_bc, jnp.ones(N), (MU_FAST,) * 2, 1.0)
    ref = jmg.jacobi(jl, jnp.zeros(N), jnp.asarray(rhs.numpy()), bvals, 1)
    assert _err(j1, ref) < 1e-14
    assert _err(g1, jmg.gsrb(jl, jnp.zeros(N), jnp.asarray(rhs.numpy()),
                             bvals, 1)) < 1e-14
    assert float((j1 - g1).abs().max()) > 1e-6
    calls = []
    real = tmg.jacobi

    def spy(*a):
        calls.append(a[-1])
        return real(*a)

    tmg.jacobi = spy
    try:
        _, (_, iters, ratio) = tmg.solve(N, DXH, ell_bc, aco, (MU_FAST,) * 2,
                                         rhs, alpha=1.0, bvals=bvals,
                                         rel_eps=1e-12, return_info=True)
    finally:
        tmg.jacobi = real
    assert iters == 0 and float(ratio) <= 1.0
    assert len(calls) == 1 and 1 <= calls[0] <= 40


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("bc", sorted(HELM_BCS))
def test_laplacian_2d_matches(bc, batched):
    ell_bc, bvals = HELM_BCS[bc]
    f = smooth((2,) + N if batched else N, 8, dm=2)
    ref = jmg.laplacian(jnp.asarray(f), N, DXH, ell_bc, bvals)
    out = tmg.laplacian(torch.as_tensor(f), N, DXH, ell_bc, bvals)
    assert _err(out, ref) <= 1e-11 * float(np.max(np.abs(np.asarray(ref))))


# ---------------------------------------------------------------------------
# nodal solver and the projections
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pmask", [(False, False), (True, False)])
def test_nodal_pieces_2d_match(pmask):
    n, dx = (16, 12), (0.1, 0.13)
    rng = np.random.RandomState(2)
    ns = tnd.node_shape(n, pmask)
    assert ns == jnd.node_shape(n, pmask)
    np.testing.assert_allclose(tnd.element_matrix(dx), jnd.element_matrix(dx),
                               atol=1e-15)
    sigma = rng.rand(*n) + 0.5
    phi = rng.rand(*ns) - 0.5
    u = rng.rand(2, *n) - 0.5
    js, ts = jnp.asarray(sigma), torch.as_tensor(sigma)
    jlv = jnd.NodalLevel(n, dx, pmask, js, jnd.node_diag(js, dx, pmask, 2),
                         None)
    tlv = tnd.NodalLevel(n, dx, pmask, ts, tnd.node_diag(ts, dx, pmask, 2),
                         None)
    assert _err(tlv.diag, jlv.diag) < 1e-11
    assert _err(tnd.nd_apply(tlv, torch.as_tensor(phi)),
                jnd.nd_apply(jlv, jnp.asarray(phi))) < 1e-11
    rhs = rng.rand(*ns) - 0.5
    assert _err(tnd.jacobi(tlv, torch.as_tensor(phi), torch.as_tensor(rhs), 2),
                jnd.jacobi(jlv, jnp.asarray(phi), jnp.asarray(rhs), 2)) < 1e-11
    assert _err(tnd.divu_rhs(torch.as_tensor(u), dx, pmask, 2),
                jnd.divu_rhs(jnp.asarray(u), dx, pmask, 2)) < 1e-12
    assert _err(tnd.cell_grad(torch.as_tensor(phi), dx, pmask, 2),
                jnd.cell_grad(jnp.asarray(phi), dx, pmask, 2)) < 1e-11
    r = tck.node_restrict(torch.as_tensor(rhs), pmask, 2)
    assert _err(r, jnd._restrict(jnp.asarray(rhs), pmask, 2)) < 1e-12
    assert _err(tck.node_prolong(r, ns, pmask, 2),
                jnd._prolong(jnp.asarray(r.numpy()), ns, pmask, 2)) < 1e-12


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pmask", [(False, False), (True, False)])
def test_nodal_solve_2d_matches(pmask, masked):
    n, dx = (32, 32), (1.0 / 32,) * 2
    ns = tnd.node_shape(n, pmask)
    sigma = 1.0 / (1.0 + 0.5 * (1.0 + smooth(n, 1, amp=1.0, dm=2)))
    rhs = smooth(ns, 2, amp=1e-2, dm=2)
    mask = None
    if masked:
        mask = np.ones(ns)
        mask[:, -1] = 0.0
    kw = dict(rel_eps=1e-11, return_info=True)
    pj, (_, it_j, _) = jnd.solve(
        n, dx, pmask, jnp.asarray(sigma), jnp.asarray(rhs),
        mask=None if mask is None else jnp.asarray(mask), **kw)
    pt, (_, it_t, ratio) = tnd.solve(
        n, dx, pmask, torch.as_tensor(sigma), torch.as_tensor(rhs),
        mask=None if mask is None else torch.as_tensor(mask), **kw)
    assert int(it_t) == int(it_j) > 0 and float(ratio) <= 1.0
    assert _err(pt, pj) <= 1e-9 * float(np.max(np.abs(np.asarray(pj))))


SIM_BCS = {"walls": dict(bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15),
           "rt": dict(bcx_lo=-1, bcx_hi=-1, bcy_lo=15, bcy_hi=15),
           "advect": dict(bcx_lo=11, bcx_hi=12, bcy_lo=14, bcy_hi=14,
                          u_bc=((1.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
                          rho_bc=((1.0, 0.0), (0.0, 0.0), (0.0, 0.0)))}


def _sims(bc, **over):
    kw = dict(dim_in=2, prob_type=1, n_cellx=32, n_celly=32, grav=-9.8,
              dtype="float64", **SIM_BCS[bc])
    kw.update(over)
    return JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")


@pytest.mark.parametrize("bc", sorted(SIM_BCS))
def test_macproject_2d_matches(bc):
    js, ts = _sims(bc)
    n = js.n_cell
    umac = [smooth((n[0] + 1, n[1]), 3, dm=2), smooth((n[0], n[1] + 1), 4,
                                                     dm=2)]
    rho = 1.0 + 0.5 * (1.0 + smooth(n, 5, amp=1.0, dm=2))
    ref = jproj.macproject(js, tuple(jnp.asarray(m) for m in umac),
                           jnp.asarray(rho), jnp.zeros(n))
    out = tproj.macproject(ts, tuple(torch.as_tensor(m) for m in umac),
                           torch.as_tensor(rho), None)
    for d in range(2):
        assert _err(out[0][d], ref[0][d]) < 1e-9
    assert abs(float(out[1]) - float(ref[1])) < 1e-9 * float(ref[1])
    # the seeded faces carry a net flux through closed walls, which no
    # projection removes: div_after is held to the reference's, and to
    # solver tolerance where an outlet lets the flux out
    assert abs(float(out[2]) - float(ref[2])) < 1e-9 * float(ref[1])
    if bc == "advect":
        assert float(out[2]) < 1e-8 * float(out[1])
    assert _err(out[3], ref[3]) < 1e-9 * max(
        1.0, float(np.max(np.abs(np.asarray(ref[3])))))
    assert float(out[5]) <= 1.0


@pytest.mark.parametrize("proj_type", [1, 3, 4])
@pytest.mark.parametrize("bc", sorted(SIM_BCS))
def test_hgproject_2d_matches(bc, proj_type):
    js, ts = _sims(bc)
    n, ns = js.n_cell, js.node_shape()
    unew, uold = smooth((2,) + n, 6, dm=2), smooth((2,) + n, 7, dm=2)
    rho = 1.0 + 0.5 * (1.0 + smooth(n, 8, amp=1.0, dm=2))
    p, gp = smooth(ns, 9, dm=2), smooth((2,) + n, 10, dm=2)
    dt = 2e-3
    ja = [jnp.asarray(a) for a in (unew, uold, rho, p, gp)]
    ta = [torch.as_tensor(a) for a in (unew, uold, rho, p, gp)]
    ref = jproj.hgproject(js, proj_type, *ja, dt)
    out = tproj.hgproject(ts, proj_type, *ta, dt)
    for i, nm in enumerate(("unew", "p", "gp", "phi")):
        scale = max(1.0, float(np.max(np.abs(np.asarray(ref[i])))))
        assert _err(out[i], ref[i]) <= 1e-9 * scale, nm
    assert float(out[5]) <= 1.0


@pytest.mark.parametrize("diffusion_type", [1, 2])
@pytest.mark.parametrize("bc,visc", [("walls", 1e-3), ("walls", 5.0),
                                     ("rt", 1e-3), ("advect", 0.5)])
def test_visc_solve_2d_matches(bc, visc, diffusion_type):
    js, ts = _sims(bc)
    n = js.n_cell
    unew = smooth((2,) + n, 5, amp=0.4, dm=2)
    lapu = smooth((2,) + n, 6, amp=3.0, dm=2)
    rho = 1.0 + 0.5 * (1.0 + smooth(n, 7, amp=1.0, dm=2))
    mu = 0.5 * 2e-3 * visc
    pj = ref_jit(lambda u, l, r: jproj.visc_solve(
        js, u, l, r, jnp.zeros(n), mu, diffusion_type))(
        jnp.asarray(unew), jnp.asarray(lapu), jnp.asarray(rho))
    pt, (_, cycles, ratio) = tproj.visc_solve(
        ts, torch.as_tensor(unew), torch.as_tensor(lapu),
        torch.as_tensor(rho), None, mu, diffusion_type, return_info=True)
    assert float(ratio) <= 1.0
    assert (cycles == 0) == (visc < 0.1)     # fast path, or V-cycles
    assert _err(pt, pj) <= 1e-10
    assert _err(pt, unew) > 1e-7


@pytest.mark.parametrize("diffusion_type", [1, 2])
def test_diff_scalar_solve_2d_matches(diffusion_type):
    js, ts = _sims("walls")
    n = js.n_cell
    snew = np.stack([1.0 + 0.5 * (1.0 + smooth(n, 8, amp=1.0, dm=2)),
                     smooth(n, 9, amp=0.5, dm=2)])
    laps = smooth((2,) + n, 10, amp=3.0, dm=2)
    mu = 0.5 * 2e-3 * 1e-2
    pj = ref_jit(lambda s, l: jproj.diff_scalar_solve(
        js, s, l, mu, diffusion_type))(jnp.asarray(snew), jnp.asarray(laps))
    pt = tproj.diff_scalar_solve(ts, torch.as_tensor(snew),
                                 torch.as_tensor(laps), mu, diffusion_type)
    assert _err(pt[0], snew[0]) == 0.0
    assert _err(pt, pj) <= 1e-11
    assert _err(pt[1], snew[1]) > 1e-7
