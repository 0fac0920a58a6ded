"""varden_tpu_torch's config, BC engine, state and initial data against
varden_tpu on the same inputs (float64, CPU). Tolerances: exact equality
for tables and parsed fields; 1e-14 for ghost fills and initial data (the
same float64 formulas, evaluated by another library)."""
import dataclasses
import glob
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_inputs import one_torch_thread  # noqa: F401
from varden_tpu import bc as jbc
from varden_tpu import config as jcfg
from varden_tpu import problems as jprob
from varden_tpu.state import Sim as JSim
from varden_tpu_torch import bc as tbc
from varden_tpu_torch import config as tcfg
from varden_tpu_torch import problems as tprob
from varden_tpu_torch.state import Sim as TSim, state_from_numpy, state_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BC_SETS = [(15, 15, 15, 15, 15, 15), (-1, -1, -1, -1, -1, -1),
           (11, 12, 14, 14, 13, 13), (-1, -1, 15, 15, 12, 12)]


def _kw(bc, n=(16, 24, 16), **extra):
    kw = dict(dim_in=3, prob_type=1, n_cellx=n[0], n_celly=n[1],
              n_cellz=n[2], bcx_lo=bc[0], bcx_hi=bc[1], bcy_lo=bc[2],
              bcy_hi=bc[3], bcz_lo=bc[4], bcz_hi=bc[5], grav=-9.8,
              dtype="float64", u_bc=((0.7, 0.0), (0.0, 0.0), (0.0, 0.0)),
              rho_bc=((1.3, 0.0), (0.0, 0.0), (0.0, 0.0)))
    kw.update(extra)
    return kw


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(ROOT, "inputs", "*"))))
def test_inputs_parse_to_same_fields(path):
    a = dataclasses.asdict(jcfg.load_config(path))
    b = dataclasses.asdict(tcfg.load_config(path))
    assert a == b
    assert tcfg.load_config(path).torch_dtype == {
        "float32": torch.float32, "float64": torch.float64}[b["dtype"]]


@pytest.mark.parametrize("bc", BC_SETS)
def test_bc_tables_match(bc):
    jc, tc = jcfg.VardenConfig(**_kw(bc)), tcfg.VardenConfig(**_kw(bc))
    assert jbc.adv_bc_table(jc) == tbc.adv_bc_table(tc)
    assert jbc.ell_bc_table(jc) == tbc.ell_bc_table(tc)
    assert jbc.bc_values(jc) == tbc.bc_values(tc)


@pytest.mark.parametrize("codes", [
    (tbc.EXT_DIR, tbc.FOEXTRAP), (tbc.HOEXTRAP, tbc.REFLECT_EVEN),
    (tbc.REFLECT_ODD, tbc.EXT_DIR), (tbc.ADV_INTERIOR, tbc.ADV_INTERIOR)])
def test_fill_ghost_every_recipe(codes):
    rng = np.random.RandomState(1)
    f = rng.randn(2, 5, 6, 7)
    bc = [codes, codes[::-1], codes]
    vals = [[0.5, -0.25], [1.0, 2.0], [-3.0, 0.0]]
    for ng in (1, 3):
        a = np.array(jbc.fill_ghost(jnp.asarray(f), ng, bc, vals, dm=3))
        b = tbc.fill_ghost(torch.as_tensor(f), ng, bc, vals, dm=3).numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-14)
    umac = [rng.randn(*[(5, 6, 7)[t] + (t == d) for t in range(3)])
            for d in range(3)]
    for pm in ((False, False, False), (True, False, True)):
        ja = jbc.grow_mac(tuple(jnp.asarray(u) for u in umac), 1, pm)
        tb = tbc.grow_mac(tuple(torch.as_tensor(u) for u in umac), 1, pm)
        for x, y in zip(ja, tb):
            np.testing.assert_array_equal(y.numpy(), np.array(x))


@pytest.mark.parametrize("prob_type", [1, 2, 3, 4])
def test_initdata_matches(prob_type):
    kw = _kw(BC_SETS[0], prob_type=prob_type)
    js, ts = JSim(jcfg.VardenConfig(**kw)), TSim(tcfg.VardenConfig(**kw),
                                                 device="cpu")
    a, b = jprob.initdata(js), tprob.initdata(ts)
    for k in ("u", "s", "gp", "p"):
        np.testing.assert_allclose(getattr(b, k).numpy(),
                                   np.array(getattr(a, k)), atol=1e-14)


@pytest.mark.parametrize("bc", BC_SETS)
def test_sim_fills_and_masks(bc):
    kw = _kw(bc)
    js, ts = JSim(jcfg.VardenConfig(**kw)), TSim(tcfg.VardenConfig(**kw),
                                                 device="cpu")
    rng = np.random.RandomState(4)
    u, s = rng.randn(3, 16, 24, 16), rng.randn(2, 16, 24, 16)
    np.testing.assert_allclose(ts.fill_vel(torch.as_tensor(u)).numpy(),
                               np.array(js.fill_vel(jnp.asarray(u))), atol=1e-14)
    np.testing.assert_allclose(ts.fill_scal(torch.as_tensor(s)).numpy(),
                               np.array(js.fill_scal(jnp.asarray(s))), atol=1e-14)
    np.testing.assert_allclose(
        ts.fill_extrap(torch.as_tensor(u), 2).numpy(),
        np.array(js.fill_extrap(jnp.asarray(u), 2)), atol=1e-14)
    assert ts.node_shape() == js.node_shape()
    jm, tm = js.nodal_mask(), ts.nodal_mask()
    assert (jm is None) == (tm is None)
    if jm is not None:
        np.testing.assert_array_equal(tm.numpy(), np.array(jm))
    assert ts.eps(1e-12) == js.eps(1e-12)


@pytest.mark.parametrize("code", [-1, 0, 1, 2, 3, 4])
def test_bottom_solver_codes_match(code):
    kw = _kw(BC_SETS[0], mg_bottom_solver=code, hg_bottom_solver=code)
    js, ts = JSim(jcfg.VardenConfig(**kw)), TSim(tcfg.VardenConfig(**kw),
                                                 device="cpu")
    assert (ts.mg_bottom, ts.hg_bottom) == (js.mg_bottom, js.hg_bottom)


def test_state_round_trip():
    ts = TSim(tcfg.VardenConfig(**_kw(BC_SETS[0])), device="cpu")
    st = tprob.initdata(ts)
    arrs, hints = state_to_numpy(st, {"phi_mac": st.s[0]})
    st2, h2 = state_from_numpy(ts, arrs, hints)
    for k in ("u", "s", "gp", "p"):
        assert torch.equal(getattr(st, k), getattr(st2, k))
    assert torch.equal(h2["phi_mac"], st.s[0])


def test_varden_without_device_needs_a_card():
    from varden_tpu_torch.driver import Varden
    cfg = tcfg.VardenConfig(**_kw(BC_SETS[0]))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Varden(cfg)
    assert Varden(cfg, device="cpu").sim.device.type == "cpu"


@pytest.mark.parametrize("extra", [
    dict(mesh=2), dict(use_godunov_debug=True)])
def test_mesh_and_debug_paths_build(extra, monkeypatch):
    """The mesh case: an AMR run on a process group of two ranks builds
    (every patch decomposed over the ranks: tests/test_torch_decomp_amr
    .py); what still raises under a mesh is a mesh that is not the group's
    size (ValueError). The Godunov debug oracle (use_godunov_debug) builds
    and one step runs on the CPU, through the oracle (the step's full
    comparison with varden_tpu is tests/test_torch_godunov_ref.py)."""
    import torch.distributed as dist
    from varden_tpu_torch.driver import Varden
    from varden_tpu_torch.ops import godunov_ref
    if "mesh" in extra:
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda: 2)
        monkeypatch.setattr(dist, "get_rank", lambda: 0)
        extra = dict(extra, max_levs=2)
        v = Varden(tcfg.VardenConfig(**_kw(BC_SETS[0], **extra)),
                   device="cpu")
        assert v.ml and v.sim.ml_ranks == 2 and v.sim.dec is None
        with pytest.raises(ValueError, match="2 ranks"):
            Varden(tcfg.VardenConfig(**_kw(BC_SETS[0], **dict(extra,
                                                              mesh=4))),
                   device="cpu")
        return
    calls = []
    for name in ("velpred_3d", "mkflux_3d"):
        def spy(*a, _f=getattr(godunov_ref, name), _n=name, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(godunov_ref, name, spy)
    v = Varden(tcfg.VardenConfig(**_kw(BC_SETS[0], n=(8, 8, 8), **extra)),
               device="cpu")
    state = v.step(v.initialize())
    # the initial pressure iterations and the step: the predictor, then
    # the scalars' and the velocity's edge states, each time
    assert v.istep == 1 and len(calls) % 3 == 0 and calls
    assert calls == ["velpred_3d", "mkflux_3d", "mkflux_3d"] * (
        len(calls) // 3)
    assert all(torch.isfinite(getattr(state, k)).all()
               for k in ("u", "s", "gp", "p"))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, varden_tpu_torch, varden_tpu_torch.driver, "
            "varden_tpu_torch.__main__\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'varden_tpu' or "
            "m.startswith('varden_tpu.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
