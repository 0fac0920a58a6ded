"""Kernel 7's fused stages and kernel 9's tile pass, their own CUDA code run
on the CPU through the emulator of tools/cuda_emu (the .cu rewritten for
g++ against a stub runtime: one std::thread per CUDA thread, barriers for
__syncthreads, shared memory filled with NaN before each block), against
the plain versions:

  kernel 7 (csrc/gsrb_padded.cu, the x-marching pass of gsrb3d.cuh with
    the ghost ring frozen at each sweep's start): "smooth" (one to three
    sweeps, a coarse correction at cfac (2, 2, 2), (2, 1, 2) or (1, 2, 2))
    and "smooth_restrict" (one and two sweeps) on grids of 7 to 40 cells
    an axis, x periodic, y and z each periodic, Neumann, Dirichlet with
    non-zero face values or ghost, alpha on and off, and odd periodic
    extents (where a colour meets itself across the wrap, one sweep a
    launch), where "smooth" alone is taken: exact;
  kernel 9 (csrc/velpred2d.cu, one tile pass): the physical BC sets of
    test_torch_emu2d.py, slope orders 4, 2 and 0, use_minion on and off,
    at 20 x 24 and 70 x 9 (several tiles, ragged edges): 1e-12 of each
    output's largest value (exact in practice: g++ contracts no
    multiply-add on this target either).

Skipped where g++ is missing."""
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from test_torch_emu2d import BCS_2D, _sim_2d
from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import smooth as _smooth

from varden_tpu_torch.ops import _cuda
from varden_tpu_torch.ops import cuda_godunov as cg
from varden_tpu_torch.ops import cuda_kernels as ck
from varden_tpu_torch.solvers import mg

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the emulator compiles with g++")

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "cuda_emu")


@pytest.fixture(scope="module", autouse=True)
def emulated():
    """Route the wrappers' launches to the emulated libraries for this
    module only."""
    sys.path.insert(0, TOOLS)
    import emulate
    saved = _cuda.call, _cuda.check
    emulate.install()
    yield
    _cuda.call, _cuda.check = saved
    sys.path.remove(TOOLS)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,ell_bc,alpha", [
    ((16, 8, 16), [(0, 0), (0, 0), (1, 1)], 0.0),
    ((8, 16, 10), [(0, 0), (2, 1), (3, 2)], 0.7),
    ((12, 8, 40), [(0, 0), (1, 3), (0, 0)], 0.0),
    ((9, 7, 11), [(0, 0), (0, 0), (2, 2)], 0.3),
])
def test_gsrb_padded_fused_emulated(n, ell_bc, alpha, dtype):
    rng = np.random.RandomState(sum(n))
    kw = dict(dtype=dtype)
    dx = (0.1, 0.13, 0.12)
    beta = tuple(torch.as_tensor(0.5 + rng.rand(
        *[n[t] + (1 if t == d else 0) for t in range(3)]), **kw)
        for d in range(3))
    aco = torch.as_tensor(1.0 + rng.rand(*n), **kw)
    lev = mg.make_level(n, dx, ell_bc, aco, beta, alpha)
    phi = torch.as_tensor(rng.rand(*n) - 0.5, **kw)
    rhs = torch.as_tensor(rng.rand(*n) - 0.5, **kw)
    bv = [[0.0, 0.0], [0.2, -0.3], [0.15, 0.4]]
    g = (phi, rhs, lev.inv_diag, lev.beta, dx, aco, alpha)
    runs = [("smooth", ns, None, (2, 2, 2)) for ns in (1, 3)]
    for fac in ((2, 2, 2), (2, 1, 2), (1, 2, 2)):
        if all(s % f == 0 for s, f in zip(n, fac)):
            c = torch.as_tensor(rng.rand(*[s // f for s, f in zip(n, fac)])
                                - 0.5, **kw)
            runs.append(("smooth", 2, c, fac))
    if all(s % 2 == 0 for s in n):
        runs += [("smooth_restrict", ns, None, (2, 2, 2)) for ns in (1, 2)]
    # two sweeps a launch, one where a periodic extent is odd
    odd = any(0 in ell_bc[d] and n[d] % 2 for d in range(3))
    for emit, ns, corr, fac in runs:
        a = dict(emit=emit, ell_bc=ell_bc, bvals=bv, nsweeps=ns, corr=corr,
                 cfac=fac)
        before = ck.gsrb_sweep_3d.fused_launches
        out = ck._gsrb_padded_launch(*g, emit, ell_bc, bv, ns, corr, fac)
        assert ck.gsrb_sweep_3d.fused_launches \
            == before + (ns if odd else (ns + 1) // 2)
        ref = ck.gsrb_sweep_3d_plain(*g, **a)
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        for o, r in zip(outs, refs):
            assert torch.equal(o, r), (emit, ns, fac,
                                       float((o - r).abs().max()))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("bc", BCS_2D)
def test_velpred2d_tile_emulated(bc, dtype):
    # two of the four (size, slope order, use_minion) rows a BC set, in turn
    rows = [((20, 24), 4, False), ((70, 9), 2, True), ((20, 24), 4, True),
            ((70, 9), 0, False)]
    i = BCS_2D.index(bc)
    for n, order, use_minion in (rows[i % 4], rows[(i + 1) % 4]):
        sim = _sim_2d(bc, n, dtype)
        ng = sim.ng
        u = sim.fill_vel(sim.tensor(_smooth((2,) + n, 11, 0.6, dm=2)))
        f = sim.fill_extrap(sim.tensor(_smooth((2,) + n, 12, 0.3, dm=2)), ng)
        args = (u, f, 0.9 * sim.dx[0] / 0.6, sim.dx, sim.phys_bc,
                [sim.adv_bc[d] for d in range(2)], ng, n, order, use_minion)
        before = cg.velpred_2d_fused.launches
        out = cg._velpred2d_launch(*args)
        assert cg.velpred_2d_fused.launches == before + 2
        ref = cg.velpred_2d_plain(*args)
        for i, nm in enumerate(("umac", "vmac")):
            assert out[i].shape == ref[i].shape
            scale = max(float(ref[i].abs().max()), 1e-300)
            err = float((out[i] - ref[i]).abs().max())
            assert err <= 1e-12 * scale, (
                f"{nm} n={n} order={order} minion={use_minion}: {err} "
                f"(scale {scale})")
