"""varden_tpu_torch.profiling against varden_tpu.profiling (float64, CPU).

Each phase of phase_fns (premac, mac, scalar, hg) against the composition
of varden_tpu's public functions that varden_tpu's profile_phases jits,
on one numpy-made state of the viscous bubble in 2-D at 16^2 and 3-D at
8^3 (varden_tpu's windowed Godunov path stands for its Pallas kernels,
which compute the same function): 1e-10 of each output's size. Then
profile_phases and profile_phases_ml return the reference's keys and print
its summary lines, report() prints the spans' four-column table in its
order while the summary is on and nothing once it is off, and trace()
writes a Chrome trace."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import ref_jit, smooth

from varden_tpu import problems as jprob
from varden_tpu import projection as jproj
from varden_tpu.advance import embed_faces as jembed
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.ops import basic as jbasic
from varden_tpu.ops import godunov as jg2
from varden_tpu.ops import godunov3d as jg3
from varden_tpu.state import Sim as JSim, State as JState
from varden_tpu_torch import profiling
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.driver import Varden
from varden_tpu_torch.state import Sim as TSim, state_from_numpy

FIELDS = ("u", "s", "gp", "p")
TOL = 1e-10
DT = 2e-3


def _kw(dm):
    n = 16 if dm == 2 else 8
    kw = dict(dim_in=dm, prob_type=1, n_cellx=n, n_celly=n, grav=-9.8,
              dtype="float64", visc_coef=1e-3, bcx_lo=15, bcx_hi=15,
              bcy_lo=15, bcy_hi=15)
    if dm == 3:
        kw.update(n_cellz=n, bcz_lo=15, bcz_hi=15)
    return kw


def _rel(t, j):
    j = np.asarray(j)
    return float(np.max(np.abs(t.detach().numpy() - j))) / max(
        1.0, float(np.max(np.abs(j))))


def _jax_phases(sim):
    """varden_tpu's profile_phases phases (varden_tpu/profiling.py:58-175),
    the windowed Godunov functions in place of the Pallas kernels."""
    cfg, dm, ng, n = sim.cfg, sim.dm, sim.ng, sim.n_cell
    adv_v = [sim.adv_bc[d] for d in range(dm)]
    adv_s = [sim.adv_bc[sim.scal_comp(i)] for i in range(sim.nscal)]
    is_cons = [True] + [False] * (sim.nscal - 1)
    tail = (cfg.slope_order, cfg.use_minion)

    def premac(state, dt):
        vf = jbasic.mkvelforce(cfg.ext_force, state.s, state.gp,
                               jnp.zeros_like(state.u), cfg.visc_coef, 1.0,
                               cfg.boussinesq)
        vp = jg2.velpred_2d if dm == 2 else jg3.velpred_3d
        return vp(sim.fill_vel(state.u), sim.fill_extrap(vf, ng), dt, sim.dx,
                  sim.phys_bc, adv_v, ng, n, *tail)

    def mac(state, umac):
        return jproj.macproject(sim, umac, state.s[0])

    def scalar(state, umac, dt):
        laps = jnp.zeros_like(state.s)
        sf = jbasic.mkscalforce(jnp.zeros_like(state.s), laps, cfg.diff_coef,
                                1.0)
        s_pad = sim.fill_scal(state.s)
        sf_pad = sim.fill_extrap(sf, ng)
        mrhs = sim.fill_extrap(jnp.zeros(n, sim.dtype), ng)
        mp = jembed(sim, umac, ng)
        args = (sf_pad, mrhs, dt, sim.dx, sim.phys_bc, adv_s, ng, n, False,
                is_cons, *tail)
        if dm == 2:
            ex, ey, fx, fy = jg2.mkflux_2d(s_pad, mp[0], mp[1], *args)
            sedge, sflux = (ex, ey), (fx, fy)
        else:
            sedge, sflux = jg3.mkflux_3d(s_pad, mp, *args)
        sf2 = jbasic.mkscalforce(jnp.zeros_like(state.s), laps, cfg.diff_coef,
                                 0.0)
        return jbasic.update(state.s, umac, sedge, sflux, sf2, dt, sim.dx,
                             is_cons)

    def hg(state, snew, dt):
        rhohalf = jbasic.make_at_halftime(state.s[0], snew[0])
        return jproj.hgproject(sim, jproj.REGULAR_TIMESTEP, state.u, state.u,
                               rhohalf, state.p, state.gp, dt)

    return premac, mac, scalar, hg


def _states(dm):
    kw = _kw(dm)
    js, ts = JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")
    st = jprob.initdata(js)
    arrs = {k: np.array(getattr(st, k)) for k in FIELDS}
    n = js.n_cell
    arrs["u"] = arrs["u"] + smooth((dm,) + n, 1, amp=0.2, dm=dm)
    arrs["gp"] = smooth((dm,) + n, 2, amp=0.5, dm=dm)
    jst = JState(**{k: jnp.asarray(v) for k, v in arrs.items()})
    return js, ts, jst, state_from_numpy(ts, arrs)[0]


@pytest.mark.parametrize("dm", [2, 3])
def test_phase_fns_match_varden_tpu(dm):
    js, ts, jst, tst = _states(dm)
    premac, mac, scalar, hg = (ref_jit(f) for f in _jax_phases(js))
    f = profiling.phase_fns(ts)
    assert set(f) == {"premac", "mac", "scalar", "hg"}
    jumac = premac(jst, DT)
    umac = f["premac"](tst, DT)
    for d in range(dm):
        assert _rel(umac[d], jumac[d]) < TOL, f"premac face {d}"
    jm, tm = mac(jst, jumac), f["mac"](tst, umac)
    for d in range(dm):
        assert _rel(tm[0][d], jm[0][d]) < TOL, f"mac face {d}"
    assert _rel(tm[3], jm[3]) < TOL, "mac phi"
    jsnew = scalar(jst, jm[0], DT)
    snew = f["scalar"](tst, tm[0], DT)
    assert _rel(snew, jsnew) < TOL, "scalar"
    jh, th = hg(jst, jsnew, DT), f["hg"](tst, snew, DT)
    for k, what in enumerate(("u", "p", "gp", "phi")):
        assert _rel(th[k], jh[k]) < TOL, f"hg {what}"


def test_profile_phases_keys_and_summary(capsys):
    """The reference's keys and summary lines, single level (2-D) and over
    a two-level hierarchy (3-D), each phase's seconds positive."""
    v = Varden(TCfg(**_kw(2)), device="cpu")
    state = v.initialize()
    out = profiling.profile_phases(v.sim, state, v.dt, n_rep=1)
    assert list(out) == ["Velocity update (premac)", "MAC Projection",
                         "Scalar update", "HG Projection"]
    assert all(t > 0.0 for t in out.values())
    lines = capsys.readouterr().out.splitlines()
    i = lines.index("Timing summary:")
    for k, (name, t) in enumerate(out.items()):
        assert lines[i + 1 + k] == f"  {name}: {t:.6f} seconds"

    kw = dict(_kw(3), max_levs=2)
    v = Varden(TCfg(**kw), device="cpu")
    states = v.initialize_ml()
    out = profiling.profile_phases_ml(v.geom, states, v.dt, n_rep=1)
    assert list(out) == ["Velocity update (premac, all levels)",
                         "MAC Projection (composite)",
                         "HG Projection (composite)"]
    assert all(t > 0.0 for t in out.values())
    lines = capsys.readouterr().out.splitlines()
    head = (f"Timing summary ({v.geom.nlev} patches, {v.geom.ndepth} "
            f"levels):")
    i = lines.index(head)
    for k, (name, t) in enumerate(out.items()):
        assert lines[i + 1 + k] == f"  {name}: {t:.6f} seconds"


def test_scoped_report_and_trace(tmp_path):
    profiling.reset()
    try:
        for _ in range(2):
            with profiling.span("mg::build"):
                pass
        with profiling.span("step::estdt"):
            sum(range(200000))
        rep = profiling.report().splitlines()
        assert rep[0] == "%-28s %8s %12s %12s" % ("REGION", "COUNT",
                                                  "TOTAL(s)", "MEAN(s)")
        assert [ln.split()[0] for ln in rep[1:]] == ["step::estdt",
                                                     "mg::build"]
        assert rep[2].split()[1] == "2"
        profiling.reset()
        assert profiling.report().splitlines()[1:] == []
    finally:
        profiling.reset(on=False)
    with profiling.span("mg::build"):
        pass
    assert profiling.report().splitlines()[1:] == []
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    with open(os.path.join(tmp_path, "tr", "trace.json")) as f:
        assert "traceEvents" in json.load(f)
