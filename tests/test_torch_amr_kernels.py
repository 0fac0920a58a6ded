"""The plain versions of the AMR slice's two kernels against varden_tpu
(float64, CPU): update_3d (kernel 6, csrc/update.cu) against basic.update
and against the TPU kernel pallas_kernels.update_3d in interpret mode;
mkflux_3d_fused (kernel 11, csrc/mkflux.cu) against godunov3d.mkflux_3d and
against the TPU kernel pallas_godunov.mkflux_3d_fused in interpret mode.
Tolerance 1e-12 absolute on O(1) fields: the formulas are the same op for
op. The wrappers run their plain versions on CPU tensors; the kernels
themselves are held to those on the card (test_torch_kernels_gpu.py). The
varden_tpu functions run under jax.jit (one compile instead of hundreds of
eagerly dispatched ops)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import ref_jit
from varden_tpu import advance as jadv
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.ops import basic as jbasic
from varden_tpu.ops import godunov3d as jg3
from varden_tpu.ops import pallas_godunov as jpg
from varden_tpu.ops import pallas_kernels as jpk
from varden_tpu.state import Sim as JSim
from varden_tpu_torch import advance as tadv
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.ops import basic as tbasic
from varden_tpu_torch.ops import cuda_godunov as tcg
from varden_tpu_torch.ops import cuda_update as tcu
from varden_tpu_torch.state import Sim as TSim

TOL = 1e-12


def _close(t, j, what):
    err = float(np.max(np.abs(np.asarray(t) - np.asarray(j))))
    assert err < TOL, f"{what}: {err}"


def _faces(rng, lead, n, shift=0.0):
    return tuple(rng.rand(*(lead + tuple(n[t] + (1 if t == d else 0)
                                         for t in range(3)))) - shift
                 for d in range(3))


def _update_inputs(n, is_cons, seed):
    rng = np.random.RandomState(seed)
    nc = len(is_cons)
    return (rng.rand(nc, *n), _faces(rng, (), n, 0.5), _faces(rng, (nc,), n),
            _faces(rng, (nc,), n), rng.rand(nc, *n) - 0.5)


# (n, conservative mask): odd and thin extents, nc 2 mixed and 3 convective
UPDATE_CASES = [((5, 7, 9), [True, False]), ((3, 1, 6), [False] * 3),
                ((4, 6, 2), [True, True])]


@pytest.mark.parametrize("n,is_cons", UPDATE_CASES)
def test_update_plain_matches_basic_update(n, is_cons):
    sold, umac, sedge, flux, force = _update_inputs(n, is_cons, 3)
    dt, dx = 2e-3, (0.1, 0.11, 0.12)
    ref = jbasic.update(jnp.asarray(sold), [jnp.asarray(u) for u in umac],
                        [jnp.asarray(e) for e in sedge],
                        [jnp.asarray(f) for f in flux], jnp.asarray(force),
                        dt, dx, is_cons)
    t = [torch.tensor(a) for a in (sold, force)]
    got = tbasic.update(t[0], [torch.tensor(u) for u in umac],
                        [torch.tensor(e) for e in sedge],
                        [torch.tensor(f) for f in flux], t[1], dt, dx,
                        is_cons)
    _close(got, ref, "update")
    # no force (None) is the zero force; an absent sedge / flux is unread
    ref0 = jbasic.update(jnp.asarray(sold), [jnp.asarray(u) for u in umac],
                         [jnp.asarray(e) for e in sedge],
                         [jnp.asarray(f) for f in flux],
                         jnp.zeros_like(jnp.asarray(force)), dt, dx, is_cons)
    got0 = tcu.update_3d(t[0], [torch.tensor(u) for u in umac],
                         None if all(is_cons) else
                         [torch.tensor(e) for e in sedge],
                         None if not any(is_cons) else
                         [torch.tensor(f) for f in flux], None, dt, dx,
                         is_cons)
    _close(got0, ref0, "update without force")


def test_update_plain_matches_the_tpu_kernel_interpreted():
    n = (8, 8, 16)
    for is_cons in ([True, False], [False] * 3):
        sold, umac, sedge, flux, force = _update_inputs(n, is_cons, 5)
        dt, dx = 2e-3, (0.1, 0.11, 0.12)
        ref = jpk.update_3d(jnp.asarray(sold), [jnp.asarray(u) for u in umac],
                            [jnp.asarray(e) for e in sedge],
                            [jnp.asarray(f) for f in flux],
                            jnp.asarray(force), dt, dx, is_cons,
                            interpret=True)
        got = tcu.update_3d_plain(torch.tensor(sold),
                                  [torch.tensor(u) for u in umac],
                                  [torch.tensor(e) for e in sedge],
                                  [torch.tensor(f) for f in flux],
                                  torch.tensor(force), dt, dx, is_cons)
        _close(got, ref, f"update {is_cons} vs the interpreted TPU kernel")


def _sims(bc, n):
    kw = dict(dim_in=3, prob_type=1, n_cellx=n[0], n_celly=n[1],
              n_cellz=n[2], bcx_lo=bc[0], bcx_hi=bc[1], bcy_lo=bc[2],
              bcy_hi=bc[3], bcz_lo=bc[4], bcz_hi=bc[5], grav=-9.8,
              dtype="float64", u_bc=((0.7, 0.0), (0.0, 0.0), (0.0, 0.0)),
              rho_bc=((1.3, 0.0), (0.0, 0.0), (0.0, 0.0)))
    return JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")


def _mkflux_inputs(js, ts, kind, seed):
    """(numpy s_pad, force pad or None, mac pads of both packages, adv_bc,
    is_vel, conservative mask) of the scalars ('scal', 'scal+force') or
    the velocity ('vel') on seeded MAC faces."""
    n, ng = js.n_cell, js.ng
    rng = np.random.RandomState(seed)
    umac = _faces(rng, (), n, 0.5)
    jmac = jadv.embed_faces(js, tuple(jnp.asarray(u) for u in umac), ng)
    tmac = tadv.embed_faces(ts, tuple(torch.tensor(u) for u in umac), ng)
    force = None
    if kind == "vel":
        s_pad = np.array(js.fill_vel(jnp.asarray(0.5 * rng.randn(3, *n))))
        adv = [js.adv_bc[d] for d in range(3)]
        cons = [False] * 3
        force = np.array(js.fill_extrap(jnp.asarray(rng.rand(3, *n) - 0.5),
                                        ng))
    else:
        s = 1.0 + rng.rand(2, *n)
        s_pad = np.array(js.fill_scal(jnp.asarray(s)))
        adv = [js.adv_bc[js.scal_comp(i)] for i in range(2)]
        cons = [True, False]
        if kind == "scal+force":
            f = rng.rand(2, *n) - 0.5
            f[0] = 0.0
            force = np.array(js.fill_extrap(jnp.asarray(f), ng))
    return s_pad, force, jmac, tmac, adv, kind == "vel", cons


# (bc codes x lo/hi, y lo/hi, z lo/hi, extents): walls, periodic x with an
# odd thin grid, inlet / outlet / slip
MKFLUX_CASES = [((15,) * 6, (8, 10, 12)), ((-1, -1, 15, 15, 14, 14),
                                          (6, 3, 9)),
                ((11, 12, 14, 14, 13, 13), (8, 8, 6))]


@pytest.mark.parametrize("bc,n,kind", [
    (*MKFLUX_CASES[0], "scal"), (*MKFLUX_CASES[1], "scal+force"),
    (*MKFLUX_CASES[2], "vel")],
    ids=["walls-scal", "per-odd-scal+force", "inlet-vel"])
def test_mkflux_plain_matches_godunov3d(bc, n, kind):
    js, ts = _sims(bc, n)
    s_pad, force, jmac, tmac, adv, is_vel, cons = _mkflux_inputs(js, ts, kind,
                                                                 7)
    dt, ng = 2e-3, js.ng
    jf = (jnp.asarray(force) if force is not None
          else jnp.zeros_like(jnp.asarray(s_pad)))
    ref = ref_jit(lambda s, m, f: jg3.mkflux_3d(
        s, m, f, jnp.zeros(s_pad.shape[1:]), dt, js.dx, js.phys_bc, adv, ng,
        n, is_vel, cons, js.cfg.slope_order, False))(jnp.asarray(s_pad),
                                                     jmac, jf)
    got = tcg.mkflux_3d_fused(torch.tensor(s_pad), tmac,
                              None if force is None else torch.tensor(force),
                              None, dt, ts.dx, ts.phys_bc, adv, ng, n,
                              is_vel, cons, ts.cfg.slope_order, False)
    for part, (g, r) in zip(("sedge", "sflux"), zip(got, ref)):
        for d in range(3):
            _close(g[d], r[d], f"{part}[{d}]")


def test_mkflux_plain_matches_the_tpu_kernel_interpreted():
    """At small extents that the TPU kernel's tile plan accepts."""
    n = (16, 32, 8)
    js, ts = _sims((15,) * 6, n)
    s_pad, force, jmac, tmac, adv, is_vel, cons = _mkflux_inputs(
        js, ts, "scal+force", 11)
    dt, ng = 2e-3, js.ng
    ref = ref_jit(lambda s, m, f: jpg.mkflux_3d_fused(
        s, m, f, jnp.zeros(s_pad.shape[1:]), dt, js.dx, js.phys_bc, adv, ng,
        n, False, cons, js.cfg.slope_order, False, interpret=True))(
            jnp.asarray(s_pad), jmac, jnp.asarray(force))
    got = tcg.mkflux_3d_plain(torch.tensor(s_pad), tmac, torch.tensor(force),
                              None, dt, ts.dx, ts.phys_bc, adv, ng, n, False,
                              cons, ts.cfg.slope_order, False)
    for part, (g, r) in zip(("sedge", "sflux"), zip(got, ref)):
        for d in range(3):
            _close(g[d], r[d], f"{part}[{d}] vs the interpreted TPU kernel")


@pytest.mark.parametrize("kind,minion", [("scal", True), ("vel", False),
                                         ("scal+force", True)])
def test_mkflux_wrapper_umax_and_absent_inputs(kind, minion):
    """Kernel 11's wrapper on the CPU with the level's umax given (the tie
    epsilon formed from it, as varden_tpu's eps argument sets it), with
    mac_rhs present under use_minion, and with force and mac_rhs absent
    (None) against varden_tpu's zero tensors."""
    bc, n = MKFLUX_CASES[2]
    js, ts = _sims(bc, n)
    s_pad, force, jmac, tmac, adv, is_vel, cons = _mkflux_inputs(js, ts, kind,
                                                                 13)
    dt, ng = 2e-3, js.ng
    rhs = np.array(js.fill_extrap(jnp.asarray(
        np.random.RandomState(14).rand(*n) - 0.5), ng))
    umax = 2.5
    jf = (jnp.asarray(force) if force is not None
          else jnp.zeros_like(jnp.asarray(s_pad)))

    def reference(eps):
        return ref_jit(lambda s, m, f, r: jg3.mkflux_3d(
            s, m, f, r, dt, js.dx, js.phys_bc, adv, ng, n, is_vel, cons,
            js.cfg.slope_order, minion, eps=eps))

    # one compile for each umax, mac_rhs being an argument
    refs = {given: reference(None if given is None
                             else jnp.asarray(1e-8 * given))
            for given in (None, umax)}
    for with_rhs in (False, True):
        jr = jnp.asarray(rhs) if with_rhs else jnp.zeros(s_pad.shape[1:])
        for given in (None, umax):
            ref = refs[given](jnp.asarray(s_pad), jmac, jf, jr)
            got = tcg.mkflux_3d_fused(
                torch.tensor(s_pad), tmac,
                None if force is None else torch.tensor(force),
                torch.tensor(rhs) if with_rhs else None, dt, ts.dx,
                ts.phys_bc, adv, ng, n, is_vel, cons, ts.cfg.slope_order,
                minion, umax=None if given is None else torch.tensor(given))
            for part, (g, r) in zip(("sedge", "sflux"), zip(got, ref)):
                for d in range(3):
                    _close(g[d], r[d], f"{part}[{d}] rhs={with_rhs} "
                                       f"umax={given}")
