"""The port's red-black sweep on a ghost-padded phi (ops.cuda_kernels
.gsrb_sweep_3d; its plain version on CPU tensors) and the multigrid route
that takes it, against varden_tpu (float64, CPU).

The sweep against varden_tpu's TPU kernel pallas_kernels.gsrb_sweep_3d in
interpret mode: 1e-12 on grids the TPU kernel keeps in one x tile (measured
2.2e-16: the same arithmetic in the same order). On (64, 16, 16) the TPU
kernel tiles x by 32, and across that seam its black cells read stale red
values (a Mosaic tiling artifact the port does not copy): there the two
differ exactly on the black cells of x-planes 31 and 32.

mg.gsrb on a periodic-x level of even extents >= 8 is the ghost pad
followed by the padded sweep, and equals varden_tpu's mg.gsrb with its
accelerator route forced (1e-12); an odd periodic level keeps the exact
sweep. mg.solve of a periodic-x MAC operator holds to varden_tpu's
accelerator route at 1e-9 relative (both run the same V-cycles to rel_eps
1e-10). Against varden_tpu's unpatched CPU route (the exact sweep) the two
would agree only to the solver's tolerance."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import force_padded_route, ref_jit, smooth
from varden_tpu.ops import pallas_kernels as jpk
from varden_tpu.solvers import mg as jmg
from varden_tpu_torch.ops import cuda_kernels as tck
from varden_tpu_torch.solvers import mg as tmg

DX = (0.1, 0.11, 0.12)
BV = [[0.0, 0.0], [0.3, -0.2], [0.5, 0.25]]
# (interior, ell_bc, alpha): x periodic, y and z each Dirichlet (non-zero
# face values), Neumann, periodic or ghost (coarse-fine zero)
SWEEP_CASES = [
    ((8, 8, 8), [(0, 0), (2, 2), (1, 1)], 0.0),
    ((16, 8, 24), [(0, 0), (2, 1), (1, 2)], 0.7),
    ((32, 16, 16), [(0, 0), (0, 0), (1, 1)], 0.0),
    ((16, 24, 8), [(0, 0), (3, 3), (0, 0)], 0.7),
    ((32, 8, 16), [(0, 0), (1, 2), (2, 3)], 0.0),
    ((8, 10, 6), [(0, 0), (2, 3), (3, 2)], 0.7),
]


def _problem(n, ell_bc, alpha, seed=3):
    rng = np.random.RandomState(seed)
    beta = [0.5 + rng.rand(*[n[t] + (1 if t == d else 0) for t in range(3)])
            for d in range(3)]
    aco = 1.0 + rng.rand(*n)
    phi, rhs = rng.rand(*n) - 0.5, rng.rand(*n) - 0.5
    jl = jmg.make_level(n, DX, ell_bc, jnp.asarray(aco),
                        tuple(jnp.asarray(b) for b in beta), alpha)
    tl = tmg.make_level(n, DX, ell_bc, torch.as_tensor(aco),
                        tuple(torch.as_tensor(b) for b in beta), alpha)
    return jl, tl, phi, rhs


def _sweeps(n, ell_bc, alpha):
    """(port plain sweep, TPU kernel in interpret mode) on one padded phi."""
    jl, tl, phi, rhs = _problem(n, ell_bc, alpha)
    pad = np.array(jmg._pad_ghost(jnp.asarray(phi), ell_bc, BV, 3))
    inv = tl.inv_diag.numpy()
    want = jpk.gsrb_sweep_3d(jnp.asarray(pad), jnp.asarray(rhs),
                             jnp.asarray(inv), list(jl.beta), DX,
                             aco=jl.aco, alpha=alpha, interpret=True)
    got = tck.gsrb_sweep_3d(torch.as_tensor(pad), torch.as_tensor(rhs),
                            tl.inv_diag, list(tl.beta), DX, aco=tl.aco,
                            alpha=alpha)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("n,ell_bc,alpha", SWEEP_CASES)
def test_sweep_matches_the_tpu_kernel(n, ell_bc, alpha):
    got, want = _sweeps(n, ell_bc, alpha)
    assert got.shape == n
    assert float(np.max(np.abs(got - want))) <= 1e-12


def test_sweep_drops_the_tile_seam_lag():
    n = (64, 16, 16)
    got, want = _sweeps(n, [(0, 0), (0, 0), (1, 1)], 0.0)
    idx = np.indices(n)
    seam_black = (np.isin(idx[0], (31, 32))
                  & (idx.sum(axis=0) % 2 == 1))
    assert np.array_equal(np.abs(got - want) > 1e-12, seam_black)


def test_black_cells_see_the_unrefreshed_ring():
    """One sweep equals red then black on the same pad with the red-updated
    interior spliced in, and differs from an exact sweep that re-pads
    between the colours."""
    n, ell_bc = (16, 8, 8), [(0, 0), (2, 2), (1, 1)]
    _jl, tl, phi, rhs = _problem(n, ell_bc, 0.0)
    phi, rhs = torch.as_tensor(phi), torch.as_tensor(rhs)
    pad = tmg._pad_ghost(phi, ell_bc, BV, 3)
    got = tck.gsrb_sweep_3d(pad, rhs, tl.inv_diag, list(tl.beta), DX)
    red = (tck._colour_index(n, "cpu") % 2 == 0)
    r1 = rhs - tmg.apply_padded(pad, tl.aco, tl.beta, 0.0, DX, 3)
    mid = torch.where(red, phi + r1 * tl.inv_diag, phi)
    pad2 = pad.clone()
    pad2[1:-1, 1:-1, 1:-1] = mid
    r2 = rhs - tmg.apply_padded(pad2, tl.aco, tl.beta, 0.0, DX, 3)
    spliced = torch.where(red, mid, mid + r2 * tl.inv_diag)
    assert float((got - spliced).abs().max()) <= 1e-12
    exact = tck.gsrb_var_sweep_3d_plain(phi, rhs, tl.inv_diag, tl.beta, DX,
                                        ell_bc, BV)
    assert float((got - exact).abs().max()) > 1e-3


@pytest.mark.parametrize("n,ell_bc,want", [
    ((16, 16, 16), [(0, 0), (0, 0), (1, 1)], True),
    ((8, 8, 8), [(0, 0), (1, 1), (1, 1)], True),
    ((16, 16, 16), [(1, 1), (0, 0), (1, 1)], False),
    ((15, 9, 8), [(0, 0), (1, 1), (2, 2)], False),
    ((4, 4, 4), [(0, 0), (0, 0), (1, 1)], False),
])
def test_padded_route_selection(n, ell_bc, want):
    """The route of varden_tpu's accelerator: x periodic, every extent even
    and >= 8, face-tensor beta, no batch axis."""
    _jl, tl, phi, _rhs = _problem(n, ell_bc, 0.0)
    phi = torch.as_tensor(phi)
    assert tmg._padded_route(tl, phi) is want
    assert not tmg._padded_route(tl, phi[None])
    scalar = tmg.make_level(n, DX, ell_bc, tl.aco, (1.0, 1.0, 1.0), 0.0)
    assert not tmg._padded_route(scalar, phi)


@pytest.mark.parametrize("n,ell_bc,alpha", [
    ((16, 8, 24), [(0, 0), (2, 1), (1, 2)], 0.0),
    ((8, 16, 8), [(0, 0), (0, 0), (3, 2)], 0.7),
])
def test_gsrb_takes_the_padded_sweep(monkeypatch, n, ell_bc, alpha):
    jl, tl, phi, rhs = _problem(n, ell_bc, alpha)
    phi_t, rhs_t = torch.as_tensor(phi), torch.as_tensor(rhs)
    out = tmg.gsrb(tl, phi_t, rhs_t, BV, 2)
    ref = phi_t
    for _ in range(2):
        ref = tck.gsrb_sweep_3d_plain(tmg._pad_ghost(ref, ell_bc, BV, 3),
                                      rhs_t, tl.inv_diag, list(tl.beta), DX,
                                      aco=tl.aco, alpha=alpha)
    assert torch.equal(out, ref)
    calls = force_padded_route(monkeypatch)
    want = ref_jit(lambda p, r: jmg.gsrb(jl, p, r, BV, 2))(
        jnp.asarray(phi), jnp.asarray(rhs))
    assert calls
    assert float(np.max(np.abs(out.numpy() - np.asarray(want)))) <= 1e-12


def test_odd_periodic_level_keeps_the_exact_sweep():
    n, ell_bc = (15, 9, 8), [(0, 0), (1, 1), (2, 2)]
    jl, tl, phi, rhs = _problem(n, ell_bc, 0.0)
    out = tmg.gsrb(tl, torch.as_tensor(phi), torch.as_tensor(rhs), BV, 3)
    want = ref_jit(lambda p, r: jmg.gsrb(jl, p, r, BV, 3))(
        jnp.asarray(phi), jnp.asarray(rhs))
    assert float(np.max(np.abs(out.numpy() - np.asarray(want)))) <= 1e-11


@pytest.mark.parametrize("n,ell_bc", [
    ((16, 16, 16), [(0, 0), (0, 0), (1, 1)]),
    ((16, 8, 24), [(0, 0), (1, 1), (2, 2)]),
])
def test_solve_matches_the_accelerator_route(monkeypatch, n, ell_bc):
    """A MAC operator (beta = 1/rho on faces of a layered density) with x
    periodic: config 4's boundaries, and Neumann / Dirichlet on y and z."""
    rng = np.random.RandomState(5)
    z = (np.arange(n[2]) + 0.5) / n[2]
    rho = 1.5 + 0.5 * np.tanh((z - 0.5) / 0.1) + 0.05 * rng.rand(*n)
    beta = []
    for d in range(3):
        lo = np.concatenate([rho.take([0], d), rho], axis=d)
        hi = np.concatenate([rho, rho.take([-1], d)], axis=d)
        beta.append(2.0 / (lo + hi))
    rhs = smooth(n, 8, amp=10.0)
    calls = force_padded_route(monkeypatch)
    kw = dict(rel_eps=1e-10)
    jphi, jrn = ref_jit(lambda r: jmg.solve(
        n, DX, ell_bc, jnp.zeros(n), [jnp.asarray(b) for b in beta], r,
        **kw))(jnp.asarray(rhs))
    assert calls
    tphi, _ = tmg.solve(n, DX, ell_bc, torch.zeros(n),
                        [torch.as_tensor(b) for b in beta],
                        torch.as_tensor(rhs), **kw)
    scale = float(np.max(np.abs(np.asarray(jphi))))
    assert float(np.max(np.abs(tphi.numpy() - np.asarray(jphi)))) \
        <= 1e-9 * scale
