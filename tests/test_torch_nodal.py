"""The port's nodal (hg) solver and the nodal_sweep_3d wrapper (its plain
version on CPU tensors) against varden_tpu on the same inputs (float64,
CPU).

Tolerances: 1e-12 on O(1) operator applications (the same factored
arithmetic, summed in another order); 1e-9 relative for solves (both run
the same V-cycles to rel_eps 1e-10, so they agree to well inside the solver
tolerance); 1e-8 relative with the iterative bottom solvers, whose stop
tests may fall on either side of a roundoff-level difference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_inputs import smooth as _smooth

from varden_tpu.ops import pallas_kernels as jpk
from varden_tpu.solvers import nodal as jnd
from varden_tpu_torch.ops import cuda_kernels as tck
from varden_tpu_torch.solvers import nodal as tnd

DX = (0.1, 0.13, 0.07)
PMASKS = [(False, False, False), (True, False, True)]
# the solver cases keep dx isotropic: at a 1.5:1 cell aspect ratio the
# nodal V-cycle of both packages stalls far above its tolerance
N = (16, 24, 16)


def _err(t, j):
    return float(np.max(np.abs(t.numpy() - np.asarray(j))))


def _nodal_inputs(n, pmask, seed):
    rng = np.random.RandomState(seed)
    ns = tnd.node_shape(n, pmask)
    sigma = rng.rand(*n) + 0.5
    phi = rng.rand(*ns) - 0.5
    rhs = rng.rand(*ns) - 0.5
    return sigma, phi, rhs


@pytest.mark.parametrize("pmask", PMASKS)
def test_factored_apply_and_diag_match(pmask):
    n = (8, 12, 6)
    sigma, phi, _ = _nodal_inputs(n, pmask, 1)
    ref = jnd._factored_apply(jnp.asarray(phi), jnp.asarray(sigma), DX,
                              pmask, 3)
    out = tnd._factored_apply(torch.as_tensor(phi), torch.as_tensor(sigma),
                              DX, pmask, 3)
    assert _err(out, ref) < 1e-12
    assert _err(tnd.node_diag(torch.as_tensor(sigma), DX, pmask, 3),
                jnd.node_diag(jnp.asarray(sigma), DX, pmask, 3)) < 1e-12
    np.testing.assert_allclose(tnd.element_matrix(DX),
                               jnd.element_matrix(DX), rtol=0, atol=1e-15)


@pytest.mark.parametrize("pmask", PMASKS)
def test_nodal_sweep_emits_match_the_tpu_kernel(pmask):
    n = (8, 12, 6)
    sigma, phi, rhs = _nodal_inputs(n, pmask, 2)
    inv = 1.0 / np.asarray(jnd.node_diag(jnp.asarray(sigma), DX, pmask, 3))
    jpad = jnd._pad_node(jnp.asarray(phi), pmask, 3)
    jsig = jnd._sigma_np(jnp.asarray(sigma), pmask, 3)
    tpad = tck.node_pad(torch.as_tensor(phi), pmask, 3)
    tsig = tck.node_sigma_np(torch.as_tensor(sigma), pmask, 3)
    assert _err(tpad, jpad) == 0.0 and _err(tsig, jsig) == 0.0
    for emit in ("apply", "residual", "jacobi"):
        ref = jpk.nodal_sweep_3d(jpad, jsig, jnp.asarray(rhs),
                                 jnp.asarray(inv), DX, emit=emit,
                                 interpret=True)
        out = tck.nodal_sweep_3d(tpad, tsig, torch.as_tensor(rhs),
                                 torch.as_tensor(inv), DX, emit=emit)
        assert _err(out, ref) < 1e-12, emit


@pytest.mark.parametrize("pmask,with_mask", [
    ((False, False, False), False), ((True, False, True), False),
    ((False, False, False), True)])
def test_nodal_solve_matches(pmask, with_mask):
    sigma = 1.0 / (5.5 + 9.0 * _smooth(N, 3))
    rhs = _smooth(tnd.node_shape(N, pmask), 4)
    dx = (1.0 / 16,) * 3
    ns = tnd.node_shape(N, pmask)
    mask = None
    if with_mask:  # an outlet on the high y side
        mask = np.ones(ns)
        mask[:, -1, :] = 0.0
    kw = dict(rel_eps=1e-10, abs_eps=-1.0, return_info=True)
    pj, (rn_j, it_j, _) = jax.jit(lambda s, r, m: jnd.solve(
        N, dx, pmask, s, r, mask=m, **kw))(
        jnp.asarray(sigma), jnp.asarray(rhs),
        None if mask is None else jnp.asarray(mask))
    pt, (rn_t, it_t, ratio) = tnd.solve(
        N, dx, pmask, torch.as_tensor(sigma), torch.as_tensor(rhs),
        mask=None if mask is None else torch.as_tensor(mask), **kw)
    assert int(it_t) == int(it_j)
    assert float(ratio) <= 1.0
    scale = float(np.max(np.abs(np.asarray(pj))))
    assert _err(pt, pj) < 1e-9 * scale


@pytest.mark.parametrize("bottom", ["smoother", "cg", "bicgstab"])
@pytest.mark.parametrize("pmask,with_mask", [
    ((False, False, False), False), ((True, False, True), True)])
def test_nodal_solve_with_each_bottom_solver(pmask, with_mask, bottom):
    sigma = 1.0 / (5.5 + 9.0 * _smooth(N, 3))
    ns = tnd.node_shape(N, pmask)
    rhs = _smooth(ns, 4)
    dx = (1.0 / 16,) * 3
    mask = None
    if with_mask:
        mask = np.ones(ns)
        mask[:, -1, :] = 0.0
    kw = dict(rel_eps=1e-10, abs_eps=-1.0, return_info=True, bottom=bottom)
    pj, (rn_j, it_j, ratio_j) = jax.jit(lambda s, r, m: jnd.solve(
        N, dx, pmask, s, r, mask=m, **kw))(
        jnp.asarray(sigma), jnp.asarray(rhs),
        None if mask is None else jnp.asarray(mask))
    pt, (rn_t, it_t, ratio_t) = tnd.solve(
        N, dx, pmask, torch.as_tensor(sigma), torch.as_tensor(rhs),
        mask=None if mask is None else torch.as_tensor(mask), **kw)
    # ten smoothing sweeps are a weak bottom solver: on some of these
    # problems both packages stall above the tolerance (ratio > 1), after
    # the same number of cycles; the Krylov bottoms converge
    assert int(it_t) == int(it_j)
    assert abs(float(ratio_t) - float(ratio_j)) <= 1e-2 * float(ratio_j)
    if bottom != "smoother":
        assert float(ratio_t) <= 1.0
    scale = float(np.max(np.abs(np.asarray(pj))))
    assert _err(pt, pj) < 1e-8 * scale
