"""The gsrb_const_sweep_3d wrapper (its plain version on CPU tensors) and
mg.laplacian against varden_tpu on the same inputs (float64, CPU).

The exact red-black sweep is held to the jnp mg.gsrb on a scalar-beta
level (the TPU kernel's sweep is a per-x-tile hybrid, see
pallas_kernels.py:312-313), the residual to the TPU kernel in interpret
mode and to rhs - cc_apply, the Laplacian to mg.laplacian. Tolerance 1e-11
on O(1)-O(100) values: the same arithmetic in float64, summed in another
order. The TPU kernel takes no periodic x and only even extents >= 8, so
those BC sets are held to the jnp functions alone."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varden_tpu.ops import pallas_kernels as jpk
from varden_tpu.solvers import mg as jmg
from varden_tpu_torch.ops import cuda_kernels as tck
from varden_tpu_torch.solvers import mg as tmg

DX = (0.1, 0.11, 0.12)
BETA = (0.03, 0.03, 0.03)
BV = [[0.2, -0.3], [0.15, 0.0], [0.0, 0.4]]
# (n, ell_bc): PER 0, NEU 1, DIR 2, GHOST 3
CASES = [
    ((16, 8, 32), [(2, 2), (2, 2), (2, 2)]),      # DIR with non-zero bvals
    ((16, 8, 8), [(1, 2), (2, 1), (0, 0)]),       # NEU/DIR mix, periodic z
    ((8, 16, 8), [(0, 0), (1, 1), (2, 2)]),       # periodic x
    ((9, 7, 5), [(0, 0), (0, 0), (1, 3)]),        # odd periodic extents, GHOST
]


def _problem(n, ell_bc, B, alpha, seed=11):
    rng = np.random.RandomState(seed)
    aco = 1.0 + 9.0 * rng.rand(*n)
    phi = rng.rand(B, *n) - 0.5
    rhs = rng.rand(B, *n) - 0.5
    jl = jmg.make_level(n, DX, ell_bc, jnp.asarray(aco), BETA, alpha)
    tl = tmg.make_level(n, DX, ell_bc, torch.as_tensor(aco), BETA, alpha)
    coef = [BETA[d] / DX[d] ** 2 for d in range(3)] + [alpha]
    return jl, tl, aco, phi, rhs, coef


def _err(t, j):
    return float(np.max(np.abs(t.numpy() - np.asarray(j))))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n,ell_bc", CASES)
def test_sweep_is_the_exact_red_black_sweep(n, ell_bc, B):
    jl, tl, aco, phi, rhs, coef = _problem(n, ell_bc, B, 1.0)
    assert _err(tl.diag, jl.diag) < 1e-11
    ref = jmg.gsrb(jl, jnp.asarray(phi), jnp.asarray(rhs), BV, 2)
    args = (torch.as_tensor(rhs), tl.inv_diag, coef, ell_bc, BV)
    out = torch.as_tensor(phi)
    for _ in range(2):
        out = tck.gsrb_const_sweep_3d(out, *args, aco=torch.as_tensor(aco))
    assert _err(out, ref) < 1e-11
    # and through the solver's dispatch on the scalar-beta level
    out = tmg.gsrb(tl, torch.as_tensor(phi), torch.as_tensor(rhs), BV, 2)
    assert _err(out, ref) < 1e-11
    out1 = tmg.gsrb(tl, torch.as_tensor(phi[0]), torch.as_tensor(rhs[0]), BV, 2)
    assert _err(out1, ref[0]) < 1e-11


@pytest.mark.parametrize("alpha", [0.0, 1.0])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n,ell_bc", CASES)
def test_residual_matches_cc_apply(n, ell_bc, B, alpha):
    jl, tl, aco, phi, rhs, coef = _problem(n, ell_bc, B, alpha, seed=5)
    ref = jnp.asarray(rhs) - jmg.cc_apply(jl, jnp.asarray(phi), BV)
    out = tck.gsrb_const_sweep_3d(
        torch.as_tensor(phi), torch.as_tensor(rhs), None, coef, ell_bc, BV,
        aco=torch.as_tensor(aco) if alpha else None, emit="residual")
    assert _err(out, ref) < 1e-11
    assert _err(tmg._residual(tl, torch.as_tensor(phi), torch.as_tensor(rhs),
                              BV), ref) < 1e-11
    assert _err(tmg.cc_apply(tl, torch.as_tensor(phi), BV),
                jmg.cc_apply(jl, jnp.asarray(phi), BV)) < 1e-11


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n,ell_bc", CASES[:2])
def test_residual_matches_the_tpu_kernel(n, ell_bc, B):
    jl, tl, aco, phi, rhs, coef = _problem(n, ell_bc, B, 1.0, seed=3)
    inv = 1.0 / np.asarray(jl.diag)
    ref = jpk.gsrb_const_sweep_3d(
        jnp.asarray(phi), jnp.asarray(rhs), jnp.asarray(inv),
        jnp.asarray(coef), ell_bc, BV, aco=jnp.asarray(aco), emit="residual",
        interpret=True)
    assert ref is not None
    out = tck.gsrb_const_sweep_3d(
        torch.as_tensor(phi), torch.as_tensor(rhs), torch.as_tensor(inv),
        coef, ell_bc, BV, aco=torch.as_tensor(aco), emit="residual")
    assert _err(out, ref) < 1e-11
    # the TPU sweep differs from the exact one only at its tile edges: with
    # one red pass alone (no black cell updated yet) the two agree on red
    ref_s = jpk.gsrb_const_sweep_3d(
        jnp.asarray(phi), jnp.asarray(rhs), jnp.asarray(inv),
        jnp.asarray(coef), ell_bc, BV, aco=jnp.asarray(aco), interpret=True)
    out_s = tck.gsrb_const_sweep_3d(
        torch.as_tensor(phi), torch.as_tensor(rhs), torch.as_tensor(inv),
        coef, ell_bc, BV, aco=torch.as_tensor(aco))
    idx = np.add.outer(np.add.outer(np.arange(n[0]), np.arange(n[1])),
                       np.arange(n[2]))
    red = (idx % 2 == 0)
    assert float(np.max(np.abs((out_s.numpy() - np.asarray(ref_s))
                               [:, red]))) < 1e-11


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("n,ell_bc", CASES)
def test_laplacian_matches(n, ell_bc, batched):
    rng = np.random.RandomState(2)
    f = rng.rand(*((3,) + n if batched else n)) - 0.5
    ref = jmg.laplacian(jnp.asarray(f), n, DX, ell_bc, BV)
    out = tmg.laplacian(torch.as_tensor(f), n, DX, ell_bc, BV)
    assert out.shape == f.shape
    assert _err(out, ref) < 1e-11 * max(1.0, float(np.max(np.abs(ref))))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    n = (8, 8, 8)
    phi = torch.zeros((1,) + n, dtype=torch.float64)
    coef, bc = [1.0, 1.0, 1.0, 0.0], [(1, 1)] * 3
    with pytest.raises(ValueError, match="emit"):
        tck.gsrb_const_sweep_3d(phi, phi, phi[0], coef, bc, BV, emit="restrict")
    with pytest.raises(ValueError, match="B, n0, n1, n2"):
        tck.gsrb_const_sweep_3d(phi[0], phi[0], phi[0], coef, bc, BV)
    with pytest.raises(ValueError, match="4 entries"):
        tck.gsrb_const_sweep_3d(phi, phi, phi[0], coef[:3], bc, BV)
    with pytest.raises(ValueError, match="rhs=None"):
        tck.gsrb_const_sweep_3d(phi, None, phi[0], coef, bc, BV)
    before = tck.gsrb_const_sweep_3d.launches
    tck.gsrb_const_sweep_3d(phi, phi, phi[0], coef, bc, BV)
    # the plain version on a CPU tensor launches nothing
    assert tck.gsrb_const_sweep_3d.launches == before
