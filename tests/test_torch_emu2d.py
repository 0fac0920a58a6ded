"""The 2-D kernels' own CUDA code, run on the CPU through the emulator of
tools/cuda_emu (the .cu rewritten for g++ against a stub runtime: one
std::thread per CUDA thread, barriers for __syncthreads, shared memory
filled with NaN before each block), against the plain versions, at
16^2-24^2 and odd extents:

  kernel 8 (csrc/gsrb2d.cu): the fused stages "smooth" (one, two and
    three sweeps; a coarse correction at cfac (2, 2), (1, 2), (2, 1)) and
    "smooth_restrict" (one and two sweeps), every BC code, a periodic axis
    of odd extent (the out-of-place variant), alpha on and off: exact;
  kernel 10 (csrc/mkflux2d.cu): the tile pass on every physical BC set,
    scalars and velocity, use_minion with and without force / mac_rhs,
    slope orders 4, 2 and 0: 1e-12 of each output's largest value (exact
    in practice: g++ contracts no multiply-add on this target either).

This is the only place in the CPU tests where the kernels' code runs; the
card's tests (test_torch_kernels_gpu.py) run it as nvcc builds it.
Skipped where g++ is missing."""
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import smooth as _smooth

from varden_tpu_torch import advance
from varden_tpu_torch.config import VardenConfig
from varden_tpu_torch.ops import _cuda
from varden_tpu_torch.ops import cuda_godunov as cg
from varden_tpu_torch.ops import cuda_kernels as ck
from varden_tpu_torch.solvers import mg
from varden_tpu_torch.state import Sim

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
    ((16, 16), [(1, 2), (2, 1)], 0.0),
    ((16, 24), [(3, 3), (0, 0)], 0.7),
    ((15, 9), [(0, 0), (2, 2)], 0.0),
    ((24, 18), [(2, 3), (1, 0)], 0.0),
])
def test_gsrb2d_fused_emulated(n, ell_bc, alpha, dtype):
    rng = np.random.RandomState(sum(n))
    kw = dict(dtype=dtype)
    dx = (0.1, 0.13)
    beta = (torch.as_tensor(0.5 + rng.rand(n[0] + 1, n[1]), **kw),
            torch.as_tensor(0.5 + rng.rand(n[0], n[1] + 1), **kw))
    aco = torch.as_tensor(1.0 + rng.rand(*n), **kw)
    lev = mg.make_level(n, dx, ell_bc, aco, beta, alpha)
    phi = torch.as_tensor(rng.rand(*n) - 0.5, **kw)
    rhs = torch.as_tensor(rng.rand(*n) - 0.5, **kw)
    bv = [[0.2, -0.3], [0.15, 0.4]]
    g = (phi, rhs, lev.inv_diag, lev.beta, lev.dx, ell_bc, bv)
    runs = [("smooth", ns, None, (2, 2)) for ns in (1, 2, 3)]
    for fac in ((2, 2), (1, 2), (2, 1)):
        if all(s % f == 0 for s, f in zip(n, fac)):
            c = torch.as_tensor(rng.rand(*[s // f for s, f in zip(n, fac)])
                                - 0.5, **kw)
            runs.append(("smooth", 2, c, fac))
    if all(s % 2 == 0 for s in n):
        runs += [("smooth_restrict", ns, None, (2, 2)) for ns in (1, 2)]
    for emit, ns, corr, fac in runs:
        before = ck.gsrb_sweep_2d.fused_launches
        out = ck._gsrb2d_launch(*g, aco, alpha, emit, ns, corr, fac)
        assert ck.gsrb_sweep_2d.fused_launches == before + (ns + 1) // 2
        ref = ck.gsrb_sweep_2d_plain(*g, aco=aco, alpha=alpha, emit=emit,
                                     nsweeps=ns, corr=corr, cfac=fac)
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        for o, r in zip(outs, refs):
            assert torch.equal(o, r), f"{emit} nsweeps={ns} cfac={fac}"


# (x lo, x hi, y lo, y hi): walls; periodic; periodic x with slip walls;
# inlet/outlet in x with slip walls; symmetry in x, wall below, outlet on top
BCS_2D = [(15, 15, 15, 15), (-1, -1, -1, -1), (-1, -1, 14, 14),
          (11, 12, 14, 14), (13, 13, 15, 12)]


def _sim_2d(bc, n, dtype):
    kw = dict(dim_in=2, prob_type=1, n_cellx=n[0], n_celly=n[1],
              prob_hi_y=n[1] / n[0], bcx_lo=bc[0], bcx_hi=bc[1], bcy_lo=bc[2],
              bcy_hi=bc[3], grav=-9.8, dtype=dtype,
              u_bc=((0.7, 0.0), (0.0, 0.0), (0.0, 0.0)),
              rho_bc=((1.3, 0.0), (0.0, 0.0), (0.0, 0.0)))
    return Sim(VardenConfig(**kw), device="cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("bc", BCS_2D)
def test_mkflux2d_tile_emulated(bc, dtype):
    rows = [((20, 24), False, False, False, 4), ((20, 24), False, True, True, 4),
            ((17, 22), True, False, True, 4), ((17, 22), True, True, False, 2),
            ((20, 24), False, False, True, 0)]
    for n, is_vel, use_minion, sources, order in rows:
        sim = _sim_2d(bc, n, dtype)
        ng = sim.ng

        def sm(shape, seed, amp=0.5):
            return sim.tensor(_smooth(shape, seed, amp, dm=2))

        umac = (sm((n[0] + 1, n[1]), 10), sm((n[0], n[1] + 1), 11))
        mac_pads = [m.contiguous() for m in advance.embed_faces(sim, umac, ng)]
        if is_vel:
            s_pad = sim.fill_vel(sm((2,) + n, 3))
            adv = [sim.adv_bc[d] for d in range(2)]
            cons = [False, False]
        else:
            s_pad = sim.fill_scal(1.5 + sm((2,) + n, 6, 0.05))
            adv = [sim.adv_bc[sim.scal_comp(i)] for i in range(2)]
            cons = [True, False]
        force = rhs = None
        if sources:
            force = sim.fill_extrap(sm((2,) + n, 4, 0.2), ng)
            rhs = sim.fill_extrap(sm(n, 5, 0.2), ng)
        args = (s_pad, *mac_pads, force, rhs, 2e-3, sim.dx, sim.phys_bc,
                adv, ng, n, is_vel, cons, order, use_minion)
        before = cg.mkflux_2d_fused.launches
        out = cg._mkflux2d_launch(*args)
        assert cg.mkflux_2d_fused.launches == before + 2
        ref = cg.mkflux_2d_plain(*args)
        for i, nm in enumerate(("sedgex", "sedgey", "fluxx", "fluxy")):
            assert out[i].shape == ref[i].shape
            scale = max(float(ref[i].abs().max()), 1e-300)
            err = float((out[i] - ref[i]).abs().max())
            assert err <= 1e-12 * scale, (
                f"{nm} n={n} vel={is_vel} minion={use_minion} "
                f"sources={sources} order={order}: {err} (scale {scale})")
