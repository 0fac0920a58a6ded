"""The 3-D Rayleigh-Taylor regression inputs (inputs/inputs_RayleighTaylor_3d:
periodic x and y, no-slip walls in z, visc_coef 1e-2, max_levs 2) at an 8^3
base, where no cell is tagged and the hierarchy is one level, against
varden_tpu (float64, CPU). Its viscous solve is one batched composite solve
of the three velocity components, whose boundary values ride the batch
axis as tensors; on a one-level hierarchy that solve is a plain mg.solve,
and kernel 5's wrapper takes one set of host numbers a call (the port used
to stop there with "only one element tensors can be converted to Python
scalars"). The batched mg.solve with boundary values that differ over the
batch is held against varden_tpu's too."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import assert_runs_agree, run_inputs_both, smooth
from varden_tpu.solvers import mg as jmg
from varden_tpu_torch.bc import BC_DIR, BC_NEU, BC_PER
from varden_tpu_torch.solvers import mg as tmg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rt3d_on_a_one_level_hierarchy_follows_varden_tpu():
    jv, tv, js, ts = run_inputs_both(
        os.path.join(ROOT, "inputs", "inputs_RayleighTaylor_3d"),
        n_cellx=8, n_celly=8, n_cellz=8, max_step=2, init_iter=1)
    assert [tuple(s.n) for s in tv.geom.specs] == [(8, 8, 8)]
    assert_runs_agree(jv, tv, js, ts, tol=1e-9)


@pytest.mark.parametrize("ell", [
    ((BC_PER, BC_PER), (BC_PER, BC_PER), (BC_DIR, BC_DIR)),
    ((BC_DIR, BC_NEU), (BC_DIR, BC_DIR), (BC_DIR, BC_DIR))],
    ids=["rt", "inlet"])
def test_batched_helmholtz_with_per_component_boundary_values(ell):
    n, dx = (8, 8, 8), (1 / 8,) * 3
    rhs = smooth((3,) + n, 3)
    aco = 1.5 + smooth(n, 4, amp=0.3)
    vals = [[np.array([1.0, 0.0, -0.5]) * (1 + d + 0.25 * s)
             if ell[d][s] == BC_DIR else np.zeros(3) for s in range(2)]
            for d in range(3)]
    beta = (1e-2 * 0.01,) * 3
    kw = dict(alpha=1.0, rel_eps=1e-12, return_info=True)
    tphi, (_rn, tcyc, _r) = tmg.solve(
        n, dx, ell, torch.tensor(aco), beta, torch.tensor(rhs),
        bvals=[[torch.tensor(v).reshape(3, 1, 1, 1) for v in vd]
               for vd in vals], **kw)
    jphi, (_jrn, jcyc, _jr) = jmg.solve(
        n, dx, ell, jnp.asarray(aco), beta, jnp.asarray(rhs),
        bvals=[[jnp.asarray(v).reshape(3, 1, 1, 1) for v in vd]
               for vd in vals], **kw)
    ref = np.asarray(jphi)
    assert int(tcyc) == int(jcyc)
    assert np.abs(tphi.numpy() - ref).max() <= 1e-9 * np.abs(ref).max()
    # each component is the solve with its own boundary values
    for c in range(3):
        one, _ = tmg.solve(n, dx, ell, torch.tensor(aco), beta,
                           torch.tensor(rhs[c]),
                           bvals=[[float(v[c]) for v in vd] for vd in vals],
                           alpha=1.0, rel_eps=1e-12)
        assert np.abs(one.numpy() - ref[c]).max() <= 1e-9 * np.abs(
            ref[c]).max()
