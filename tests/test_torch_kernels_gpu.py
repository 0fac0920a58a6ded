"""Each CUDA kernel of varden_tpu_torch against its plain PyTorch version,
on the card. Marked ``gpu``; without a card every test skips.

Run on a machine with a card (the conftest imports JAX, which that machine
need not have):
    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q

Tolerances: float64 results agree to 1e-11 relative to the field's size
(the kernels round like the plain versions except where PyTorch divides by
a scalar as a multiply by its reciprocal, and where sums are reordered);
float32 to 2e-5 relative (the same differences at float32 roundoff). The
Godunov inputs are smooth fields, so an upwind choice that flips on a
roundoff-level tie changes the result by a roundoff-level amount.
"""
import numpy as np
import pytest
import torch
from torch_inputs import smooth as _smooth

from varden_tpu_torch import advance, problems
from varden_tpu_torch.config import VardenConfig
from varden_tpu_torch.ops import _cuda, cuda_godunov, cuda_kernels
from varden_tpu_torch.solvers import mg, nodal
from varden_tpu_torch.state import Sim, state_from_numpy, state_to_numpy

pytestmark = pytest.mark.gpu

RTOL = {torch.float32: 2e-5, torch.float64: 1e-11}
BCS = [(15, 15, 15), (-1, -1, -1), (-1, 15, 12), (11, 14, 13)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _close(out, ref, dtype, what):
    out, ref = out.double().cpu(), ref.double().cpu()
    scale = max(1.0, float(ref.abs().max()))
    err = float((out - ref).abs().max())
    assert err <= RTOL[dtype] * scale, f"{what}: max abs err {err} (scale {scale})"


def _sim(bc, n, dtype, device):
    kw = dict(dim_in=3, prob_type=1, n_cellx=n[0], n_celly=n[1],
              n_cellz=n[2], grav=-9.8, dtype=dtype)
    names = ("x", "y", "z")
    for d in range(3):
        lo, hi = (bc[d], bc[d]) if bc[d] != 11 else (11, 12)
        kw[f"bc{names[d]}_lo"], kw[f"bc{names[d]}_hi"] = lo, hi
    if bc[0] == 11:
        kw["u_bc"] = ((0.5, 0.0), (0.0, 0.0), (0.0, 0.0))
        kw["rho_bc"] = ((1.5, 0.0), (0.0, 0.0), (0.0, 0.0))
    return Sim(VardenConfig(**kw), device=device)


def test_kernels_build():
    if not torch.cuda.is_available():
        pytest.skip("needs nvcc and a CUDA device")
    assert _cuda.build_all() >= 0.0
    for name in _cuda.SOURCES:
        assert _cuda.lib(name) is not None


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("order,use_minion", [(4, False), (2, True),
                                              (4, True), (2, False)])
@pytest.mark.parametrize("n", [(24, 40, 16), (13, 7, 19)])
def test_velpred_kernel(cuda, bc, dtype, order, use_minion, n):
    """Kernel 1, two launches (the tie epsilon and one brick pass), at every
    physical BC code, both slope orders, with and without the minion
    forcing, at extents that are and are not multiples of the brick."""
    sim = _sim(bc, n, dtype, cuda)
    ng, n = sim.ng, sim.n_cell
    u = sim.tensor(_smooth((3,) + n, 1))
    f = sim.tensor(_smooth((3,) + n, 2, amp=0.3))
    u_pad, f_pad = sim.fill_vel(u), sim.fill_extrap(f, ng)
    adv = [sim.adv_bc[d] for d in range(3)]
    args = (u_pad, f_pad, 2e-3, sim.dx, sim.phys_bc, adv, ng, n, order,
            use_minion)
    before = cuda_godunov.velpred_3d_fused.launches
    out = cuda_godunov.velpred_3d_fused(*args)
    torch.cuda.synchronize()
    assert cuda_godunov.velpred_3d_fused.launches == before + 2
    ref = cuda_godunov.velpred_3d_plain(*args)
    for d in range(3):
        _close(out[d], ref[d], sim.dtype, f"velpred bc={bc} face {d}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("is_vel", [False, True])
def test_mkflux_update_kernel(cuda, bc, dtype, is_vel):
    sim = _sim(bc, (24, 40, 16), dtype, cuda)
    ng, n = sim.ng, sim.n_cell
    umac = tuple(sim.tensor(_smooth(tuple(n[t] + (1 if t == d else 0)
                                          for t in range(3)), 10 + d))
                 for d in range(3))
    mac_pads = advance.embed_faces(sim, umac, ng)
    if is_vel:
        s = sim.tensor(_smooth((3,) + n, 3))
        s_pad = sim.fill_vel(s)
        adv = [sim.adv_bc[d] for d in range(3)]
        cons = [False] * 3
        force = sim.fill_extrap(sim.tensor(_smooth((3,) + n, 4, 0.2)), ng)
        fupd = sim.tensor(_smooth((3,) + n, 5, 0.2))
    else:
        s = problems.initdata(sim).s + sim.tensor(_smooth((2,) + n, 6, 0.05))
        s_pad = sim.fill_scal(s)
        adv = [sim.adv_bc[sim.scal_comp(i)] for i in range(2)]
        cons = [True, False]
        force = fupd = None
    args = (s_pad, mac_pads, force, fupd, None, 2e-3, sim.dx, sim.phys_bc,
            adv, ng, n, is_vel, cons, 4, False)
    before = cuda_godunov.mkflux_update_3d_fused.launches
    out = cuda_godunov.mkflux_update_3d_fused(*args)
    torch.cuda.synchronize()
    assert cuda_godunov.mkflux_update_3d_fused.launches == before + 2
    ref = cuda_godunov.mkflux_update_3d_plain(*args)
    _close(out, ref, sim.dtype, f"mkflux_update bc={bc} is_vel={is_vel}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("n", [(24, 40, 16), (5, 3, 7), (37, 5, 61)])
@pytest.mark.parametrize("kind", ["scal", "scal+force", "vel"])
def test_mkflux_update_flux_kernel(cuda, bc, dtype, n, kind):
    """The flux option (the AMR scalar advance's call) at even, odd and
    thin extents: snew and the listed components' fluxes against the plain
    version."""
    sim = _sim(bc, n, dtype, cuda)
    ng = sim.ng
    umac = tuple(sim.tensor(_smooth(tuple(n[t] + (1 if t == d else 0)
                                          for t in range(3)), 10 + d))
                 for d in range(3))
    mac_pads = advance.embed_faces(sim, umac, ng)
    force = fupd = None
    if kind == "vel":
        s_pad = sim.fill_vel(sim.tensor(_smooth((3,) + n, 3)))
        adv = [sim.adv_bc[d] for d in range(3)]
        cons, fc = [False] * 3, (0, 2)
        force = sim.fill_extrap(sim.tensor(_smooth((3,) + n, 4, 0.2)), ng)
        fupd = sim.tensor(_smooth((3,) + n, 5, 0.2))
    else:
        s = problems.initdata(sim).s + sim.tensor(_smooth((2,) + n, 6, 0.05))
        s_pad = sim.fill_scal(s)
        adv = [sim.adv_bc[sim.scal_comp(i)] for i in range(2)]
        cons, fc = [True, False], (0,)
        if kind == "scal+force":
            f = _smooth((2,) + n, 7, 0.1)
            f[0] = 0.0
            force = sim.fill_extrap(sim.tensor(f), ng)
            fupd = sim.tensor(0.5 * f)
    args = (s_pad, mac_pads, force, fupd, None, 2e-3, sim.dx, sim.phys_bc,
            adv, ng, n, kind == "vel", cons, 4, False)
    before = cuda_godunov.mkflux_update_3d_fused.launches
    snew, sflux = cuda_godunov.mkflux_update_3d_fused(*args, flux_comps=fc)
    torch.cuda.synchronize()
    assert cuda_godunov.mkflux_update_3d_fused.launches == before + 2
    ref_new, ref_flux = cuda_godunov.mkflux_update_3d_plain(*args,
                                                            flux_comps=fc)
    _close(snew, ref_new, sim.dtype, f"snew bc={bc} n={n} {kind}")
    for d in range(3):
        assert sflux[d].shape == ref_flux[d].shape
        _close(sflux[d], ref_flux[d], sim.dtype,
               f"flux[{d}] bc={bc} n={n} {kind}")


def _mg_level(n, ell_bc, dtype, device, seed=7):
    rng = np.random.RandomState(seed)
    dx = (0.1, 0.11, 0.12)
    kw = dict(dtype=dtype, device=device)
    beta = tuple(torch.as_tensor(0.5 + rng.rand(*[n[t] + (1 if t == d else 0)
                                                   for t in range(3)]), **kw)
                 for d in range(3))
    lev = mg.make_level(n, dx, ell_bc, torch.zeros(n, **kw), beta, 0.0)
    phi = torch.as_tensor(rng.rand(*n) - 0.5, **kw)
    rhs = torch.as_tensor(rng.rand(*n) - 0.5, **kw)
    return lev, phi, rhs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,ell_bc", [
    ((16, 8, 32), [(1, 2), (2, 1), (0, 0)]),
    ((15, 9, 8), [(0, 0), (1, 1), (2, 2)]),
    ((64, 64, 64), [(1, 1), (1, 1), (1, 1)]),
])
def test_gsrb_var_kernel(cuda, dtype, n, ell_bc):
    lev, phi, rhs = _mg_level(n, ell_bc, dtype, cuda)
    bv = [[0.0, 0.3], [0.15, 0.0], [0.0, 0.0]]
    args = (phi, rhs, lev.inv_diag, lev.beta, lev.dx, ell_bc, bv)
    k = cuda_kernels
    before = k.gsrb_var_sweep_3d.launches
    for emit in ("sweep", "residual"):
        out = k.gsrb_var_sweep_3d(*args, emit=emit)
        ref = k.gsrb_var_sweep_3d_plain(*args, emit=emit)
        _close(out, ref, dtype, f"gsrb_var {emit} n={n}")
    assert k.gsrb_var_sweep_3d.launches == before + 3
    if all(s % 2 == 0 for s in n):
        crs, rmax = k.gsrb_var_sweep_3d(*args, emit="restrict")
        crs_ref, rmax_ref = k.gsrb_var_sweep_3d_plain(*args, emit="restrict")
        _close(crs, crs_ref, dtype, "gsrb_var restrict")
        _close(rmax, rmax_ref, dtype, "gsrb_var restrict max")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,ell_bc", [
    ((16, 8, 32), [(1, 2), (2, 1), (0, 0)]),
    ((15, 9, 8), [(0, 0), (1, 1), (2, 2)]),
    ((40, 36, 70), [(3, 3), (2, 0), (1, 3)]),
    ((64, 64, 64), [(1, 1), (1, 1), (1, 1)]),
])
def test_gsrb_var_fused_kernel(cuda, dtype, n, ell_bc):
    """Kernel 3's fused stages: one launch for up to two sweeps, the
    correction in the first and the restriction in the last."""
    lev, phi, rhs = _mg_level(n, ell_bc, dtype, cuda)
    bv = [[0.1, 0.3], [0.15, 0.0], [0.0, -0.2]]
    args = (phi, rhs, lev.inv_diag, lev.beta, lev.dx, ell_bc, bv)
    k = cuda_kernels
    even = all(s % 2 == 0 for s in n)
    rng = np.random.RandomState(4)
    runs = [("smooth", ns, None, (2, 2, 2)) for ns in (1, 2, 3)]
    if even:
        for fac in ((2, 2, 2), (1, 2, 2)):
            c = torch.as_tensor(rng.rand(*[s // f for s, f in zip(n, fac)])
                                - 0.5, dtype=dtype, device=cuda)
            runs.append(("smooth", 2, c, fac))
        runs += [("smooth_restrict", ns, None, (2, 2, 2)) for ns in (1, 2)]
    for emit, ns, corr, fac in runs:
        before = k.gsrb_var_sweep_3d.launches
        out = k.gsrb_var_sweep_3d(*args, emit=emit, nsweeps=ns, corr=corr,
                                  cfac=fac)
        torch.cuda.synchronize()
        assert k.gsrb_var_sweep_3d.launches == before + (ns + 1) // 2
        ref = k.gsrb_var_sweep_3d_plain(*args, emit=emit, nsweeps=ns,
                                        corr=corr, cfac=fac)
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        for o, r in zip(outs, refs):
            _close(o, r, dtype, f"gsrb_var {emit} n={n} ns={ns} fac={fac}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("alpha", [0.0, 0.7])
@pytest.mark.parametrize("n,ell_bc", [
    ((8, 8, 8), [(0, 0), (2, 2), (1, 1)]),
    ((16, 8, 24), [(0, 0), (2, 1), (1, 2)]),
    ((64, 16, 16), [(0, 0), (0, 0), (1, 1)]),
    ((15, 9, 7), [(0, 0), (3, 3), (2, 3)]),
    ((1, 5, 2), [(0, 0), (1, 2), (0, 0)]),
])
def test_gsrb_padded_kernel(cuda, dtype, alpha, n, ell_bc):
    """Kernel 7 on a ghost-padded phi (the pad of mg._pad_ghost with
    non-zero Dirichlet values), even, odd and thin extents."""
    lev, phi, rhs = _mg_level(n, ell_bc, dtype, cuda)
    aco = 1.0 + phi.abs()
    bv = [[0.0, 0.0], [0.3, -0.2], [0.5, 0.25]]
    pad = mg._pad_ghost(phi, ell_bc, bv, 3)
    args = (pad, rhs, lev.inv_diag, list(lev.beta), lev.dx)
    k = cuda_kernels
    before = k.gsrb_sweep_3d.launches
    out = k.gsrb_sweep_3d(*args, aco=aco, alpha=alpha)
    ref = k.gsrb_sweep_3d_plain(*args, aco=aco, alpha=alpha)
    assert k.gsrb_sweep_3d.launches == before + 2
    _close(out, ref, dtype, f"gsrb_padded n={n} alpha={alpha}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("alpha", [0.0, 0.7])
@pytest.mark.parametrize("n,ell_bc", [
    ((8, 8, 8), [(0, 0), (2, 2), (1, 1)]),
    ((16, 8, 24), [(0, 0), (2, 1), (1, 2)]),
    ((64, 16, 16), [(0, 0), (0, 0), (1, 1)]),
    ((32, 32, 32), [(0, 0), (0, 0), (0, 0)]),
    ((40, 36, 70), [(0, 0), (3, 2), (0, 0)]),
    ((15, 9, 7), [(0, 0), (3, 3), (2, 3)]),
])
def test_gsrb_padded_fused_kernel(cuda, dtype, alpha, n, ell_bc):
    """Kernel 7's fused stages: one launch for up to two sweeps (one a
    sweep where a periodic extent is odd), the ring formed in the kernel,
    the correction in the first and the restriction in the last;
    equal bit for bit to the composition a V-cycle called before (the ghost
    pad, the padded sweep, kernel 3's restrict emit), and to the plain
    composition within the tolerance."""
    lev, phi, rhs = _mg_level(n, ell_bc, dtype, cuda)
    aco = 1.0 + phi.abs()
    bv = [[0.0, 0.0], [0.3, -0.2], [0.5, 0.25]]
    args = (phi, rhs, lev.inv_diag, lev.beta, lev.dx)
    opt = dict(aco=aco, alpha=alpha, ell_bc=ell_bc, bvals=bv)
    k = cuda_kernels
    rng = np.random.RandomState(8)

    def single(p, ns, corr, fac, restrict):
        if corr is not None:
            p = p + k.cell_prolong(corr, fac)
        for _ in range(ns):
            p = k.gsrb_sweep_3d(mg._pad_ghost(p, ell_bc, bv, 3), *args[1:],
                                aco=aco, alpha=alpha)
        if not restrict:
            return (p,)
        return (p, *k.gsrb_var_sweep_3d(p, *args[1:], ell_bc, bv, aco=aco,
                                        alpha=alpha, emit="restrict"))

    runs = [("smooth", ns, None, (2, 2, 2)) for ns in (1, 2, 3)]
    for fac in ((2, 2, 2), (2, 1, 2)):
        if all(s % f == 0 for s, f in zip(n, fac)):
            c = torch.as_tensor(rng.rand(*[s // f for s, f in zip(n, fac)])
                                - 0.5, dtype=dtype, device=cuda)
            runs.append(("smooth", 2, c, fac))
    if all(s % 2 == 0 for s in n):
        runs += [("smooth_restrict", ns, None, (2, 2, 2)) for ns in (1, 2)]
    # two sweeps a launch, one where a periodic extent is odd
    odd = any(0 in ell_bc[d] and n[d] % 2 for d in range(3))
    for emit, ns, corr, fac in runs:
        before = (k.gsrb_sweep_3d.launches, k.gsrb_sweep_3d.fused_launches)
        out = k.gsrb_sweep_3d(*args, **opt, emit=emit, nsweeps=ns, corr=corr,
                              cfac=fac)
        torch.cuda.synchronize()
        nl = ns if odd else (ns + 1) // 2
        assert (k.gsrb_sweep_3d.launches, k.gsrb_sweep_3d.fused_launches) \
            == (before[0] + nl, before[1] + nl)
        outs = out if isinstance(out, tuple) else (out,)
        olds = single(phi, ns, corr, fac, emit == "smooth_restrict")
        ref = k.gsrb_sweep_3d_plain(*args, **opt, emit=emit, nsweeps=ns,
                                    corr=corr, cfac=fac)
        refs = ref if isinstance(ref, tuple) else (ref,)
        for o, old, r in zip(outs, olds, refs):
            what = f"gsrb_padded {emit} n={n} ns={ns} fac={fac}"
            assert torch.equal(o, old), what
            _close(o, r, dtype, what)
    if n[0] % 2:
        with pytest.raises(ValueError, match="even extents"):
            k.gsrb_sweep_3d(*args, **opt, emit="smooth_restrict", nsweeps=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n,ell_bc", [
    ((16, 8, 32), [(2, 2), (2, 2), (2, 2)]),
    ((16, 8, 8), [(1, 2), (2, 1), (0, 0)]),
    ((8, 16, 8), [(0, 0), (1, 1), (2, 2)]),
    ((9, 7, 5), [(0, 0), (0, 0), (1, 3)]),
    ((64, 64, 64), [(2, 2), (2, 2), (2, 2)]),
])
def test_gsrb_const_kernel(cuda, dtype, B, n, ell_bc):
    rng = np.random.RandomState(11)
    kw = dict(dtype=dtype, device=cuda)
    dx, mu = (0.1, 0.11, 0.12), 0.03
    aco = torch.as_tensor(1.0 + 9.0 * rng.rand(*n), **kw)
    phi = torch.as_tensor(rng.rand(B, *n) - 0.5, **kw)
    rhs = torch.as_tensor(rng.rand(B, *n) - 0.5, **kw)
    lev = mg.make_level(n, dx, ell_bc, aco, (mu,) * 3, 1.0)
    coef = [mu / h ** 2 for h in dx] + [1.0]
    bv = [[0.2, -0.3], [0.15, 0.0], [0.0, 0.4]]
    k = cuda_kernels
    before = k.gsrb_const_sweep_3d.launches
    for emit, r, a in (("sweep", rhs, aco), ("residual", rhs, aco),
                       ("residual", None, None)):
        args = (phi, r, lev.inv_diag, coef, ell_bc, bv)
        out = k.gsrb_const_sweep_3d(*args, aco=a, emit=emit)
        torch.cuda.synchronize()
        ref = k.gsrb_const_sweep_3d_plain(*args, aco=a, emit=emit)
        _close(out, ref, dtype, f"gsrb_const {emit} n={n} B={B}")
    assert k.gsrb_const_sweep_3d.launches == before + 4
    with pytest.raises(ValueError, match="contiguous"):
        k.gsrb_const_sweep_3d(phi.transpose(2, 3), rhs, lev.inv_diag, coef,
                              ell_bc, bv, aco=aco)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n,ell_bc", [
    ((16, 8, 32), [(2, 2), (2, 2), (2, 2)]),
    ((15, 9, 8), [(0, 0), (1, 1), (2, 2)]),
    ((40, 36, 70), [(3, 3), (2, 0), (1, 3)]),
    ((9, 7, 5), [(0, 0), (0, 0), (1, 3)]),
    ((64, 64, 64), [(2, 2), (2, 2), (2, 2)]),
])
def test_gsrb_const_fused_kernel(cuda, dtype, B, n, ell_bc):
    """Kernel 5's fused stages: one launch for up to two sweeps, the
    correction in the first and the restriction (max|r| over the batch) in
    the last; every elliptic BC code with non-zero face values, extents
    that do not divide the tile, odd periodic extents."""
    rng = np.random.RandomState(12)
    kw = dict(dtype=dtype, device=cuda)
    dx, mu = (0.1, 0.11, 0.12), 0.03
    aco = torch.as_tensor(1.0 + 9.0 * rng.rand(*n), **kw)
    phi = torch.as_tensor(rng.rand(B, *n) - 0.5, **kw)
    rhs = torch.as_tensor(rng.rand(B, *n) - 0.5, **kw)
    lev = mg.make_level(n, dx, ell_bc, aco, (mu,) * 3, 1.0)
    coef = [mu / h ** 2 for h in dx] + [1.0]
    bv = [[0.2, -0.3], [0.15, 0.1], [-0.1, 0.4]]
    args = (phi, rhs, lev.inv_diag, coef, ell_bc, bv)
    k = cuda_kernels
    runs = [("smooth", ns, None, (2, 2, 2)) for ns in (1, 2, 3)]
    if all(s % 2 == 0 for s in n):
        for fac in ((2, 2, 2), (1, 2, 2)):
            c = torch.as_tensor(rng.rand(B, *[s // f for s, f in zip(n, fac)])
                                - 0.5, **kw)
            runs.append(("smooth", 2, c, fac))
        runs += [("smooth_restrict", ns, None, (2, 2, 2)) for ns in (1, 2, 3)]
    for a in (aco, None):
        for emit, ns, corr, fac in runs:
            before = (k.gsrb_const_sweep_3d.launches,
                      k.gsrb_const_sweep_3d.fused_launches)
            out = k.gsrb_const_sweep_3d(*args, aco=a, emit=emit, nsweeps=ns,
                                        corr=corr, cfac=fac)
            torch.cuda.synchronize()
            step = (ns + 1) // 2
            assert (k.gsrb_const_sweep_3d.launches,
                    k.gsrb_const_sweep_3d.fused_launches) == (
                        before[0] + step, before[1] + step)
            ref = k.gsrb_const_sweep_3d_plain(*args, aco=a, emit=emit,
                                              nsweeps=ns, corr=corr,
                                              cfac=fac)
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            for o, r in zip(outs, refs):
                _close(o, r, dtype, f"gsrb_const {emit} n={n} B={B} "
                       f"ns={ns} fac={fac} aco={a is not None}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pmask", [(False, False, False), (True, False, True)])
def test_nodal_kernel(cuda, dtype, pmask):
    rng = np.random.RandomState(2)
    n, dx = (24, 16, 20), (0.1, 0.13, 0.07)
    kw = dict(dtype=dtype, device=cuda)
    ns = nodal.node_shape(n, pmask)
    sigma = torch.as_tensor(rng.rand(*n) + 0.5, **kw)
    phi = torch.as_tensor(rng.rand(*ns) - 0.5, **kw)
    rhs = torch.as_tensor(rng.rand(*ns) - 0.5, **kw)
    inv = 1.0 / nodal.node_diag(sigma, dx, pmask, 3)
    phi_pad = cuda_kernels.node_pad(phi, pmask, 3)
    sig_np = cuda_kernels.node_sigma_np(sigma, pmask, 3)
    before = cuda_kernels.nodal_sweep_3d.launches
    for emit in ("apply", "residual", "jacobi"):
        out = cuda_kernels.nodal_sweep_3d(phi_pad, sig_np, rhs, inv, dx,
                                          emit=emit)
        ref = cuda_kernels.nodal_sweep_3d_plain(phi_pad, sig_np, rhs, inv,
                                                dx, emit=emit)
        _close(out, ref, dtype, f"nodal {emit} pmask={pmask}")
    assert cuda_kernels.nodal_sweep_3d.launches == before + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,pmask", [
    ((24, 16, 20), (False, False, False)),
    ((24, 16, 20), (True, False, True)),
    ((40, 18, 70), (True, True, False)),
    ((15, 9, 7), (False, True, False)),
])
def test_nodal_fused_kernel(cuda, dtype, n, pmask):
    """Kernel 4's fused stages on the unpadded node tensor: one launch for
    up to two sweeps, no padded copy."""
    rng = np.random.RandomState(3)
    dx = (0.1, 0.13, 0.07)
    kw = dict(dtype=dtype, device=cuda)
    ns = nodal.node_shape(n, pmask)
    sigma = torch.as_tensor(rng.rand(*n) + 0.5, **kw)
    phi = torch.as_tensor(rng.rand(*ns) - 0.5, **kw)
    rhs = torch.as_tensor(rng.rand(*ns) - 0.5, **kw)
    inv = 1.0 / nodal.node_diag(sigma, dx, pmask, 3)
    runs = [("smooth", k, None) for k in (1, 2, 3)]
    if all(s % 2 == 0 for s in n):
        cn = tuple(s // 2 if p else s // 2 + 1 for s, p in zip(n, pmask))
        corr = torch.as_tensor(rng.rand(*cn) - 0.5, **kw)
        runs += [("smooth", 2, corr), ("smooth_restrict", 1, None),
                 ("smooth_restrict", 2, None)]
    k = cuda_kernels
    for emit, nsw, corr in runs:
        a = (phi, sigma, rhs, inv, dx, 0.85, emit)
        before = k.nodal_sweep_3d.launches
        out = k.nodal_sweep_3d(*a, pmask=pmask, nsweeps=nsw, corr=corr)
        torch.cuda.synchronize()
        assert k.nodal_sweep_3d.launches == before + (nsw + 1) // 2
        ref = k.nodal_sweep_3d_plain(*a, pmask=pmask, nsweeps=nsw, corr=corr)
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        for o, r in zip(outs, refs):
            _close(o, r, dtype, f"nodal {emit} n={n} pmask={pmask} ns={nsw}")


@pytest.mark.parametrize("extra", [
    {}, dict(visc_coef=1e-3, diff_coef=1e-3),
    dict(visc_coef=5.0, diff_coef=5.0, diffusion_type=2,
         mg_bottom_solver=1, hg_bottom_solver=2)],
    ids=["inviscid", "viscous", "be-vcycle-krylov"])
def test_step_on_card_matches_cpu(cuda, extra):
    """One bubble step in float64 on the card against the plain path on the
    CPU (inviscid; Crank-Nicolson on the Helmholtz fast path; backward Euler
    with a viscosity large enough for the V-cycle branch and the Krylov
    bottoms); the solvers may take other V-cycle counts, so the bound is
    set by their tolerances (rel_eps 1e-10 / 1e-12)."""
    kw = dict(dim_in=3, prob_type=1, n_cellx=16, n_celly=16, n_cellz=16,
              grav=-9.8, dtype="float64", bcx_lo=15, bcx_hi=15, bcy_lo=15,
              bcy_hi=15, bcz_lo=15, bcz_hi=15, **extra)
    cfg = VardenConfig(**kw)
    cpu, gpu = Sim(cfg, device="cpu"), Sim(cfg, device=cuda)
    st = problems.initdata(cpu)
    st.u = st.u + torch.as_tensor(_smooth((3, 16, 16, 16), 9, 0.2))
    arrs, _ = state_to_numpy(st)
    st_g, _ = state_from_numpy(gpu, arrs)
    before = cuda_kernels.gsrb_const_sweep_3d.launches
    out_c, _ = advance.advance_timestep(cpu, st, 1e-3, 4)
    out_g, _ = advance.advance_timestep(gpu, st_g, 1e-3, 4)
    assert (cuda_kernels.gsrb_const_sweep_3d.launches > before) == bool(extra)
    for k in ("u", "s", "gp", "p"):
        a, b = getattr(out_c, k), getattr(out_g, k).cpu()
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= 1e-8 * scale, k


# ---------------------------------------------------------------------------
# the 2-D kernels
# ---------------------------------------------------------------------------

# (x lo, x hi, y lo, y hi): walls; periodic; periodic x with slip walls;
# inlet/outlet in x with slip walls; symmetry in x, wall below, outlet on top
BCS_2D = [(15, 15, 15, 15), (-1, -1, -1, -1), (-1, -1, 14, 14),
          (11, 12, 14, 14), (13, 13, 15, 12)]
# odd, small and thin extents beside an ordinary one
SIZES_2D = [(24, 40), (37, 19), (5, 8), (3, 130)]


def _sim_2d(bc, n, dtype, device, **extra):
    kw = dict(dim_in=2, prob_type=1, n_cellx=n[0], n_celly=n[1],
              prob_hi_y=n[1] / n[0], bcx_lo=bc[0], bcx_hi=bc[1], bcy_lo=bc[2],
              bcy_hi=bc[3], grav=-9.8, dtype=dtype,
              u_bc=((0.7, 0.0), (0.0, 0.0), (0.0, 0.0)),
              rho_bc=((1.3, 0.0), (0.0, 0.0), (0.0, 0.0)), **extra)
    return Sim(VardenConfig(**kw), device=device)


def _smooth2(shape, seed, amp=0.5):
    return _smooth(shape, seed, amp, dm=2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("use_minion,order", [(False, 4), (True, 2)])
@pytest.mark.parametrize("n", SIZES_2D)
@pytest.mark.parametrize("bc", BCS_2D)
def test_velpred_2d_kernel(cuda, bc, n, use_minion, order, dtype):
    sim = _sim_2d(bc, n, dtype, cuda)
    ng = sim.ng
    u = sim.tensor(_smooth2((2,) + n, 1))
    f = sim.tensor(_smooth2((2,) + n, 2, amp=0.3))
    u_pad, f_pad = sim.fill_vel(u), sim.fill_extrap(f, ng)
    adv = [sim.adv_bc[d] for d in range(2)]
    args = (u_pad, f_pad, 2e-3, sim.dx, sim.phys_bc, adv, ng, n, order,
            use_minion)
    before = cuda_godunov.velpred_2d_fused.launches
    out = cuda_godunov.velpred_2d_fused(*args)
    torch.cuda.synchronize()
    assert cuda_godunov.velpred_2d_fused.launches == before + 2
    ref = cuda_godunov.velpred_2d_plain(*args)
    for d in range(2):
        assert out[d].shape == ref[d].shape
        _close(out[d], ref[d], sim.dtype, f"velpred_2d bc={bc} n={n} face {d}")
    with pytest.raises(ValueError, match="contiguous"):
        cuda_godunov.velpred_2d_fused(
            u_pad.transpose(1, 2).contiguous().transpose(1, 2), *args[1:])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("is_vel,use_minion,sources", [
    (False, False, False), (False, False, True), (False, True, True),
    (True, False, True), (True, True, True)])
@pytest.mark.parametrize("n", SIZES_2D[:3])
@pytest.mark.parametrize("bc", BCS_2D)
def test_mkflux_2d_kernel(cuda, bc, n, is_vel, use_minion, sources, dtype):
    sim = _sim_2d(bc, n, dtype, cuda)
    ng = sim.ng
    umac = (sim.tensor(_smooth2((n[0] + 1, n[1]), 10)),
            sim.tensor(_smooth2((n[0], n[1] + 1), 11)))
    mac_pads = advance.embed_faces(sim, umac, ng)
    if is_vel:
        s_pad = sim.fill_vel(sim.tensor(_smooth2((2,) + n, 3)))
        adv = [sim.adv_bc[d] for d in range(2)]
        cons = [False, False]
    else:
        s_pad = sim.fill_scal(sim.tensor(1.5 + _smooth2((2,) + n, 6, 0.05)))
        adv = [sim.adv_bc[sim.scal_comp(i)] for i in range(2)]
        cons = [True, False]
    force = rhs = None
    if sources:
        force = sim.fill_extrap(sim.tensor(_smooth2((2,) + n, 4, 0.2)), ng)
        rhs = sim.fill_extrap(sim.tensor(_smooth2(n, 5, 0.2)), ng)
    args = (s_pad, mac_pads[0], mac_pads[1], force, rhs, 2e-3, sim.dx,
            sim.phys_bc, adv, ng, n, is_vel, cons, 4, use_minion)
    before = cuda_godunov.mkflux_2d_fused.launches
    out = cuda_godunov.mkflux_2d_fused(*args)
    torch.cuda.synchronize()
    # the tie epsilon and one tile pass
    assert cuda_godunov.mkflux_2d_fused.launches == before + 2
    ref = cuda_godunov.mkflux_2d_plain(*args)
    for i, nm in enumerate(("sedgex", "sedgey", "fluxx", "fluxy")):
        assert out[i].shape == ref[i].shape
        _close(out[i], ref[i], sim.dtype,
               f"mkflux_2d bc={bc} n={n} vel={is_vel} {nm}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("order", [0, 2])
@pytest.mark.parametrize("nc,cons", [(1, [True]), (3, [True, False, True]),
                                     (4, [False, True, True, False])])
@pytest.mark.parametrize("bc", BCS_2D)
def test_mkflux_2d_kernel_components_and_orders(cuda, bc, nc, cons, order,
                                                dtype):
    """Kernel 10's tile pass with 1, 3 and 4 components (any conservative
    mask, MAXC = 4) and slope orders 2 and 0, with both sources, at an odd
    extent that spans several tiles."""
    n = (37, 70)
    sim = _sim_2d(bc, n, dtype, cuda)
    ng = sim.ng
    umac = (sim.tensor(_smooth2((n[0] + 1, n[1]), 12)),
            sim.tensor(_smooth2((n[0], n[1] + 1), 13)))
    mac_pads = advance.embed_faces(sim, umac, ng)
    s_pad = sim.fill_extrap(sim.tensor(1.5 + _smooth2((nc,) + n, 14, 0.05)),
                            ng)
    adv = [sim.adv_bc[sim.scal_comp(0)]] * nc
    force = sim.fill_extrap(sim.tensor(_smooth2((nc,) + n, 15, 0.2)), ng)
    rhs = sim.fill_extrap(sim.tensor(_smooth2(n, 16, 0.2)), ng)
    for use_minion in (False, True):
        args = (s_pad, mac_pads[0], mac_pads[1], force, rhs, 2e-3, sim.dx,
                sim.phys_bc, adv, ng, n, False, cons, order, use_minion)
        out = cuda_godunov.mkflux_2d_fused(*args)
        ref = cuda_godunov.mkflux_2d_plain(*args)
        for i, nm in enumerate(("sedgex", "sedgey", "fluxx", "fluxy")):
            assert out[i].shape == ref[i].shape
            _close(out[i], ref[i], sim.dtype,
                   f"mkflux_2d bc={bc} nc={nc} order={order} {nm}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("alpha", [0.0, 0.7])
@pytest.mark.parametrize("n,ell_bc", [
    ((32, 48), [(1, 1), (1, 1)]),
    ((16, 8), [(1, 2), (2, 1)]),
    ((15, 9), [(0, 0), (2, 2)]),
    ((7, 300), [(2, 3), (0, 0)]),
    ((2, 2), [(2, 2), (1, 1)]),
    ((1, 5), [(1, 1), (2, 2)]),
    ((8, 8), [(0, 0), (0, 0)]),
])
def test_gsrb_2d_kernel(cuda, dtype, alpha, n, ell_bc):
    rng = np.random.RandomState(5)
    kw = dict(dtype=dtype, device=cuda)
    dx = (0.1, 0.13)
    beta = (torch.as_tensor(0.5 + rng.rand(n[0] + 1, n[1]), **kw),
            torch.as_tensor(0.5 + rng.rand(n[0], n[1] + 1), **kw))
    aco = torch.as_tensor(1.0 + rng.rand(*n), **kw)
    lev = mg.make_level(n, dx, ell_bc, aco, beta, alpha)
    phi = torch.as_tensor(rng.rand(*n) - 0.5, **kw)
    rhs = torch.as_tensor(rng.rand(*n) - 0.5, **kw)
    bv = [[0.2, -0.3], [0.15, 0.4]]
    args = (phi, rhs, lev.inv_diag, lev.beta, lev.dx, ell_bc, bv)
    k = cuda_kernels
    before = k.gsrb_sweep_2d.launches
    for emit in ("sweep", "residual"):
        out = k.gsrb_sweep_2d(*args, aco=aco, alpha=alpha, emit=emit)
        torch.cuda.synchronize()
        ref = k.gsrb_sweep_2d_plain(*args, aco=aco, alpha=alpha, emit=emit)
        _close(out, ref, dtype, f"gsrb_2d {emit} n={n} alpha={alpha}")
    assert k.gsrb_sweep_2d.launches == before + 3
    if n[0] > 1:
        with pytest.raises(ValueError, match="contiguous"):
            k.gsrb_sweep_2d(phi.t().contiguous().t(), *args[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("alpha", [0.0, 0.7])
@pytest.mark.parametrize("n,ell_bc", [
    ((32, 48), [(1, 1), (1, 1)]),
    ((16, 8), [(1, 2), (2, 1)]),
    ((15, 9), [(0, 0), (2, 2)]),
    ((40, 130), [(3, 3), (0, 0)]),
    ((70, 33), [(2, 3), (0, 0)]),
    ((2, 2), [(2, 2), (1, 1)]),
    ((1, 5), [(1, 1), (2, 2)]),
    ((96, 256), [(0, 0), (2, 1)]),
])
def test_gsrb_2d_fused_kernel(cuda, dtype, alpha, n, ell_bc):
    """Kernel 8's fused stages: one launch for up to two sweeps, the
    correction in the first and the restriction in the last; equal bit for
    bit to the single passes a V-cycle called before, and to the plain
    composition within the tolerance."""
    rng = np.random.RandomState(6)
    kw = dict(dtype=dtype, device=cuda)
    dx = (0.1, 0.13)
    beta = (torch.as_tensor(0.5 + rng.rand(n[0] + 1, n[1]), **kw),
            torch.as_tensor(0.5 + rng.rand(n[0], n[1] + 1), **kw))
    aco = torch.as_tensor(1.0 + rng.rand(*n), **kw)
    lev = mg.make_level(n, dx, ell_bc, aco, beta, alpha)
    phi = torch.as_tensor(rng.rand(*n) - 0.5, **kw)
    rhs = torch.as_tensor(rng.rand(*n) - 0.5, **kw)
    bv = [[0.2, -0.3], [0.15, 0.4]]
    args = (phi, rhs, lev.inv_diag, lev.beta, lev.dx, ell_bc, bv)
    opt = dict(aco=aco, alpha=alpha)
    k = cuda_kernels

    def single(p, ns, corr, fac, restrict):
        if corr is not None:
            p = p + k.cell_prolong(corr, fac)
        for _ in range(ns):
            p = k.gsrb_sweep_2d(p, *args[1:], **opt)
        if not restrict:
            return (p,)
        r = k.gsrb_sweep_2d(p, *args[1:], **opt, emit="residual")
        return p, mg._cell_avg_down(r, 2), r.abs().max()

    runs = [("smooth", ns, None, (2, 2)) for ns in (1, 2, 3)]
    for fac in ((2, 2), (1, 2), (2, 1)):
        if all(s % f == 0 for s, f in zip(n, fac)):
            c = torch.as_tensor(rng.rand(*[s // f for s, f in zip(n, fac)])
                                - 0.5, **kw)
            runs.append(("smooth", 2, c, fac))
    if all(s % 2 == 0 for s in n):
        runs += [("smooth_restrict", ns, None, (2, 2)) for ns in (1, 2)]
    for emit, ns, corr, fac in runs:
        before = (k.gsrb_sweep_2d.launches, k.gsrb_sweep_2d.fused_launches)
        out = k.gsrb_sweep_2d(*args, **opt, emit=emit, nsweeps=ns, corr=corr,
                              cfac=fac)
        torch.cuda.synchronize()
        assert (k.gsrb_sweep_2d.launches, k.gsrb_sweep_2d.fused_launches) \
            == (before[0] + (ns + 1) // 2, before[1] + (ns + 1) // 2)
        outs = out if isinstance(out, tuple) else (out,)
        olds = single(phi, ns, corr, fac, emit == "smooth_restrict")
        ref = k.gsrb_sweep_2d_plain(*args, **opt, emit=emit, nsweeps=ns,
                                    corr=corr, cfac=fac)
        refs = ref if isinstance(ref, tuple) else (ref,)
        for o, old, r in zip(outs, olds, refs):
            what = f"gsrb_2d {emit} n={n} ns={ns} fac={fac}"
            assert torch.equal(o, old), what
            _close(o, r, dtype, what)
    if n[0] % 2:
        with pytest.raises(ValueError, match="even extents"):
            k.gsrb_sweep_2d(*args, **opt, emit="smooth_restrict", nsweeps=2)


@pytest.mark.parametrize("extra", [
    {}, dict(visc_coef=1e-4, diff_coef=1e-4),
    dict(visc_coef=1e-1, diff_coef=1e-1, diffusion_type=2)],
    ids=["inviscid", "viscous-jacobi", "be-vcycle"])
@pytest.mark.parametrize("bc", [BCS_2D[0], BCS_2D[3]], ids=["walls", "inflow"])
def test_step_2d_on_card_matches_cpu(cuda, bc, extra):
    """One 2-D step in float64 on the card against the plain path on the
    CPU: inviscid; Crank-Nicolson on the Jacobi fast path; backward Euler
    with a viscosity that sends the Helmholtz solves to V-cycles. The bound
    is set by the solvers' tolerances (rel_eps 1e-10 / 1e-12)."""
    n = (32, 32)
    cpu = _sim_2d(bc, n, "float64", "cpu", **extra)
    gpu = _sim_2d(bc, n, "float64", cuda, **extra)
    st = problems.initdata(cpu)
    st.u = st.u + torch.as_tensor(_smooth2((2,) + n, 9, 0.2))
    arrs, _ = state_to_numpy(st)
    st_g, _ = state_from_numpy(gpu, arrs)
    fns = (cuda_godunov.velpred_2d_fused, cuda_godunov.mkflux_2d_fused,
           cuda_kernels.gsrb_sweep_2d)
    before = [f.launches for f in fns]
    out_c, _ = advance.advance_timestep(cpu, st, 1e-3, 4)
    assert [f.launches for f in fns] == before  # CPU tensors: plain versions
    out_g, _ = advance.advance_timestep(gpu, st_g, 1e-3, 4)
    assert all(f.launches > b for f, b in zip(fns, before))
    for k in ("u", "s", "gp", "p"):
        a, b = getattr(out_c, k), getattr(out_g, k).cpu()
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= 1e-8 * scale, k


@pytest.mark.parametrize("n", [2048, 4096])
def test_bubble_2d_published_viscosity_leaves_the_stable_range(cuda, n):
    """The viscous 2-D bubble (walls, cflfac 0.9) with its published
    visc_coef 1e-3, far above its published 128^2: the predictor takes the
    viscous term explicitly, nu dt / dx^2 grows with the grid (33 and more
    at 2048^2, 107 and more at 4096^2) and the run loses the density bound
    [1, 2] by its third step. Run with -s for the readings per step."""
    from varden_tpu_torch.driver import Varden
    cfg = VardenConfig(dim_in=2, prob_type=1, n_cellx=n, n_celly=n,
                       grav=-9.8, dtype="float32", visc_coef=1.0e-3,
                       cflfac=0.9, init_iter=1, plot_int=-1, chk_int=-1,
                       max_levs=1, max_step=3, verbose=0, bcx_lo=15,
                       bcx_hi=15, bcy_lo=15, bcy_hi=15)
    v = Varden(cfg, device=cuda)
    state = v.initialize()
    rho_min = []
    while v.istep < 3:
        state = v.step(state)
        d = v.last_diag
        rho_min.append(float(d["smin"]))
        print(f"{n}^2 step {v.istep}: nu dt/dx^2 "
              f"{cfg.visc_coef * v.dt * n * n:.1f}; density min/max "
              f"{rho_min[-1]:.6f} / {float(d['smax']):.6f}; max|u| "
              f"{float(d['umax']):.4e}; div(umac) before MAC "
              f"{float(d['div_before']):.3e}")
    assert rho_min[-1] < 1.0 - 1e-3


# ---------------------------------------------------------------------------
# the AMR slice: update_3d (kernel 6), mkflux_3d_fused (kernel 11) and one
# multi-level step
# ---------------------------------------------------------------------------

def _face_tensors(lead, n, seed, device, dtype, shift=0.0):
    rng = np.random.RandomState(seed)
    return tuple(torch.as_tensor(rng.rand(*(lead + tuple(
        n[t] + (1 if t == d else 0) for t in range(3)))) - shift,
        dtype=dtype, device=device) for d in range(3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [(1, 1, 1), (5, 7, 9), (3, 1, 6), (2, 33, 4)])
@pytest.mark.parametrize("cons,with_force", [
    ([True, False], True), ([False] * 3, False), ([True], False)])
def test_update_kernel(cuda, dtype, n, cons, with_force):
    from varden_tpu_torch.ops import cuda_update
    nc = len(cons)
    rng = np.random.RandomState(3)
    kw = dict(dtype=dtype, device=cuda)
    sold = torch.as_tensor(rng.rand(nc, *n), **kw)
    force = (torch.as_tensor(rng.rand(nc, *n) - 0.5, **kw) if with_force
             else None)
    umac = _face_tensors((), n, 4, cuda, dtype, 0.5)
    sedge = None if all(cons) else _face_tensors((nc,), n, 5, cuda, dtype)
    flux = None if not any(cons) else _face_tensors((nc,), n, 6, cuda, dtype)
    args = (sold, umac, sedge, flux, force, 2e-3, (0.1, 0.11, 0.12), cons)
    before = cuda_update.update_3d.launches
    out = cuda_update.update_3d(*args)
    torch.cuda.synchronize()
    assert cuda_update.update_3d.launches == before + 1
    _close(out, cuda_update.update_3d_plain(*args), dtype,
           f"update n={n} cons={cons}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("n", [(24, 40, 16), (5, 3, 7), (3, 3, 3)])
@pytest.mark.parametrize("kind", ["scal", "scal+force", "vel",
                                  "scal+rhs+umax"])
def test_mkflux_kernel(cuda, bc, dtype, n, kind):
    """Kernel 11, two launches (the tie epsilon and one brick pass), with
    and without force and mac_rhs (use_minion takes them into the hat
    states), with the level's umax given."""
    sim = _sim(bc, n, dtype, cuda)
    ng = sim.ng
    umac = tuple(sim.tensor(_smooth(tuple(n[t] + (1 if t == d else 0)
                                          for t in range(3)), 10 + d))
                 for d in range(3))
    mac_pads = advance.embed_faces(sim, umac, ng)
    force = rhs = umax = None
    if kind == "vel":
        s_pad = sim.fill_vel(sim.tensor(_smooth((3,) + n, 3)))
        adv = [sim.adv_bc[d] for d in range(3)]
        cons = [False] * 3
        force = sim.fill_extrap(sim.tensor(_smooth((3,) + n, 4, 0.2)), ng)
    else:
        s = problems.initdata(sim).s + sim.tensor(_smooth((2,) + n, 6, 0.05))
        s_pad = sim.fill_scal(s)
        adv = [sim.adv_bc[sim.scal_comp(i)] for i in range(2)]
        cons = [True, False]
        if kind != "scal":
            f = _smooth((2,) + n, 7, 0.1)
            f[0] = 0.0
            force = sim.fill_extrap(sim.tensor(f), ng)
        if kind == "scal+rhs+umax":
            rhs = sim.fill_extrap(sim.tensor(_smooth(n, 8, 0.2)), ng)
            umax = sim.tensor(1.7)
    args = (s_pad, mac_pads, force, rhs, 2e-3, sim.dx, sim.phys_bc, adv, ng,
            n, kind == "vel", cons, 4, rhs is not None)
    before = cuda_godunov.mkflux_3d_fused.launches
    out = cuda_godunov.mkflux_3d_fused(*args, umax=umax)
    torch.cuda.synchronize()
    assert cuda_godunov.mkflux_3d_fused.launches == before + 2
    ref = cuda_godunov.mkflux_3d_plain(*args, umax=umax)
    for part, o, r in zip(("sedge", "sflux"), out, ref):
        for d in range(3):
            _close(o[d], r[d], sim.dtype, f"mkflux {part}[{d}] bc={bc} n={n}")


@pytest.mark.parametrize("debug", [False, True])
def test_amr_step_on_card_matches_cpu(cuda, debug):
    """One viscous 3-D ml_advance on a two-level hierarchy (16^3 base, a
    refined patch inside the domain), float64, the card against the plain
    path on the CPU from one numpy-made state: 1e-8 of each field's size
    (the composite solves stop at 1e-10 and 1e-12 of their right-hand
    sides and may take other cycle counts). With use_godunov_debug every
    level takes kernel 11 and then kernel 6 instead of kernel 2."""
    from varden_tpu_torch.amr import advance_ml
    from varden_tpu_torch.amr.fill import hierarchy_from_numpy
    from varden_tpu_torch.amr.hierarchy import LevelSpec
    from varden_tpu_torch.ops import cuda_update
    kw = dict(dim_in=3, prob_type=1, n_cellx=16, n_celly=16, n_cellz=16,
              max_levs=2, grav=-9.8, dtype="float64", visc_coef=1e-3,
              cflfac=0.5, bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15,
              bcz_lo=15, bcz_hi=15, use_godunov_debug=debug)
    cfg = VardenConfig(**kw)
    cpu = Sim(cfg, device="cpu")
    specs = [((0, 0, 0), (16, 16, 16)), ((8, 8, 4), (16, 16, 16))]
    arrays = []
    for l, (lo, n) in enumerate(specs):
        st = problems.initdata_on_spec(cpu, LevelSpec(lo, n), l)
        a = {k: getattr(st, k).numpy() for k in ("u", "s", "gp", "p")}
        a["u"] = a["u"] + _smooth(a["u"].shape, 20 + l, 0.3)
        arrays.append(a)
    out = {}
    counted = (cuda_update.update_3d, cuda_godunov.mkflux_3d_fused,
               cuda_godunov.mkflux_update_3d_fused)
    for name, sim in (("cpu", cpu), ("card", Sim(cfg, device=cuda))):
        geom, states = hierarchy_from_numpy(sim, specs, [-1, 0], [0, 1],
                                            arrays)
        before = [f.launches for f in counted]
        new, diag = advance_ml.ml_advance(geom, states, 5e-3, 4)
        out[name] = (new, diag, [f.launches - b
                                 for f, b in zip(counted, before)])
    # the scalars and the velocity of both levels through kernel 2 (the
    # scalars with their fluxes), the face kernel and the update not at
    # all; with the flag through kernels 11 and 6, kernel 2 not at all
    assert out["card"][2] == ([4, 4 * 2, 0] if debug else [0, 0, 4 * 2])
    assert out["cpu"][2] == [0, 0, 0]
    for a, b in zip(out["cpu"][0], out["card"][0]):
        for k in ("u", "s", "gp", "p"):
            x, y = getattr(a, k), getattr(b, k).cpu()
            scale = max(1.0, float(x.abs().max()))
            assert float((x - y).abs().max()) <= 1e-8 * scale, k
