"""The 3-D Godunov edge kernels' own CUDA code, run on the CPU through the
emulator of tools/cuda_emu (the .cu rewritten for g++ against a stub
runtime: one std::thread per CUDA thread, barriers for __syncthreads,
shared memory filled with NaN before each block), against the plain
versions, on odd extents that cut the bricks (8^3 in float32, 4x8x8 in
float64) unevenly, on walls, an inlet/outlet/slip/symmetry set and a
periodic box:

  kernel 11 (csrc/mkflux.cu, mkflux_3d_fused): nc 1-4, scalars (density
    conservative, tracers convective) and velocity, force and mac_rhs
    absent and present, use_minion both ways, the tie epsilon from the
    input and from a given umax: sedge and sflux on every face set;
  kernel 2 (csrc/mkflux_update.cu, mkflux_update_3d_fused), whose brick
    plan and stages kernel 11 shares (csrc/mkflux3d.cuh): snew and the
    listed conservative fluxes.

1e-12 of each output's largest value (exact in practice: g++ contracts no
multiply-add on this target either). Skipped where g++ is missing."""
import os
import shutil
import sys

import pytest
import torch
from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import smooth

from varden_tpu_torch import advance
from varden_tpu_torch.config import VardenConfig
from varden_tpu_torch.ops import _cuda
from varden_tpu_torch.ops import cuda_godunov as cg
from varden_tpu_torch.state import Sim

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the emulator compiles with g++")

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "cuda_emu")
BCS_3D = {"walls": [15] * 6, "mixed": [11, 12, 14, 14, 13, 13],
          "periodic": [-1] * 6}
# (extent, components, velocity, use_minion, force and mac_rhs)
ROWS = [((9, 10, 11), 2, False, False, False),
        ((9, 10, 11), 3, True, True, True),
        ((5, 17, 3), 1, False, True, True),
        ((12, 9, 8), 4, False, False, True)]


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


def _inputs(bc, n, nc, is_vel, sources, dtype):
    kw = dict(dim_in=3, prob_type=1, n_cellx=n[0], n_celly=n[1],
              n_cellz=n[2], grav=-9.8, dtype=dtype,
              u_bc=((0.7, 0.0), (0.0, 0.0), (0.0, 0.0)),
              rho_bc=((1.3, 0.0), (0.0, 0.0), (0.0, 0.0)))
    for d, ax in enumerate("xyz"):
        kw[f"bc{ax}_lo"], kw[f"bc{ax}_hi"] = bc[2 * d], bc[2 * d + 1]
    sim = Sim(VardenConfig(**kw), device="cpu")
    ng = sim.ng

    def sm(shape, seed, amp=0.5):
        return sim.tensor(smooth(shape, seed, amp))

    umac = tuple(sm(tuple(n[t] + (t == d) for t in range(3)), 10 + d)
                 for d in range(3))
    mac_pads = [m.contiguous() for m in advance.embed_faces(sim, umac, ng)]
    if is_vel:
        s_pad = sim.fill_vel(sm((3,) + n, 3))
        adv = [sim.adv_bc[d] for d in range(3)]
        cons = [False] * 3
    else:
        comps = [3 + min(c, 1) for c in range(nc)]
        s_pad = torch.stack([sim.fill_comp(1.5 + sm(n, 6 + c, 0.05), k, ng)
                             for c, k in enumerate(comps)])
        adv = [sim.adv_bc[k] for k in comps]
        cons = [c % 2 == 0 for c in range(nc)]
    force = rhs = None
    if sources:
        force = sim.fill_extrap(sm((nc,) + n, 4, 0.2), ng)
        rhs = sim.fill_extrap(sm(n, 5, 0.2), ng)
    return sim, umac, s_pad, mac_pads, force, rhs, adv, cons


def _hold(out, ref, what):
    assert len(out) == len(ref)
    for i, (o, r) in enumerate(zip(out, ref)):
        assert o.shape == r.shape, what
        scale = max(float(r.abs().max()), 1e-300)
        err = float((o - r).abs().max())
        assert err <= 1e-12 * scale, f"{what} output {i}: {err} ({scale})"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("bc", list(BCS_3D))
def test_mkflux3d_brick_emulated(bc, dtype):
    for n, nc, is_vel, minion, sources in ROWS:
        sim, _umac, s_pad, mp, force, rhs, adv, cons = _inputs(
            BCS_3D[bc], n, nc, is_vel, sources, dtype)
        args = (s_pad, mp, force, rhs, 2e-3, sim.dx, sim.phys_bc, adv,
                sim.ng, n, is_vel, cons, 4, minion)
        for umax in (None, sim.tensor(2.5)):
            before = cg.mkflux_3d_fused.launches
            out = cg._mkflux3d_launch(*args, umax=umax)
            assert cg.mkflux_3d_fused.launches == before + 2
            ref = cg.mkflux_3d_plain(*args, umax=umax)
            _hold(out[0] + out[1], ref[0] + ref[1],
                  f"mkflux n={n} nc={nc} vel={is_vel} umax={umax}")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mkflux_update_brick_emulated(dtype):
    for n, nc, is_vel, minion, sources in ROWS[:3]:
        sim, umac, s_pad, mp, force, rhs, adv, cons = _inputs(
            BCS_3D["mixed"], n, nc, is_vel, sources, dtype)
        fupd = sim.tensor(smooth((nc,) + n, 7, 0.1)) if sources else None
        flux = tuple(c for c in range(nc) if cons[c])[:1]
        args = (s_pad, mp, force, fupd, rhs, 2e-3, sim.dx, sim.phys_bc, adv,
                sim.ng, n, is_vel, cons, 4, minion)
        out = cg._mkflux_update_launch(*args, flux_comps=flux)
        ref = cg.mkflux_update_3d_plain(*args, flux_comps=flux)
        if flux:
            out, ref = (out[0], *out[1]), (ref[0], *ref[1])
        else:
            out, ref = (out,), (ref,)
        _hold(out, ref, f"mkflux_update n={n} nc={nc} vel={is_vel}")
