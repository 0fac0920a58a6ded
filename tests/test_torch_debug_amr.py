"""Multi-level steps with use_godunov_debug, the port against varden_tpu
(float64, CPU): two ml_advance steps of the viscous 3-D bubble on an 8^3
base with one refined patch inside the domain, from one seeded state. In
3-D the flag sends every level through varden_tpu's unfused route: in the
port the edge-state kernel (mkflux_3d_fused, whose density fluxes feed the
flux registers) and then the update kernel (update_3d), on the scalars
and the velocity of both levels, and the fused kernel not at all. Every
field of every patch within 1e-10 of its size."""
import jax.numpy as jnp
import numpy as np

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import ref_jit, smooth, state_arrays
from varden_tpu import problems as jprob
from varden_tpu.amr import advance_ml as jadv
from varden_tpu.amr import fill as jfill
from varden_tpu.amr import hierarchy as jh
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.state import Sim as JSim
from varden_tpu.state import State as JState
from varden_tpu_torch.amr import advance_ml as tadv
from varden_tpu_torch.amr import fill as tfill
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.ops import cuda_godunov as tcg
from varden_tpu_torch.ops import cuda_update as tcu
from varden_tpu_torch.state import Sim as TSim

TOL = 1e-10
KW = dict(dim_in=3, prob_type=1, n_cellx=8, n_celly=8, n_cellz=8,
          max_levs=2, grav=-9.8, dtype="float64", visc_coef=1.0e-3,
          cflfac=0.5, use_godunov_debug=True, bcx_lo=15, bcx_hi=15,
          bcy_lo=15, bcy_hi=15, bcz_lo=15, bcz_hi=15)
FINE = ((4, 4, 2), (8, 8, 8))  # level-1 index space


def test_debug_ml_advance_matches_varden_tpu(monkeypatch):
    js, ts = JSim(JCfg(**KW)), TSim(TCfg(**KW), device="cpu")
    specs = [jh.domain_spec(js.n_cell, 0), jh.LevelSpec(*FINE)]
    jg = jfill.MLGeom(js, specs)
    arrays = []
    for l, spec in enumerate(specs):
        a = state_arrays([jprob.initdata_on_spec(js, spec, l)])[0]
        a["u"] = a["u"] + smooth(a["u"].shape, 20 + l, 0.3)
        a["gp"] = smooth(a["gp"].shape, 30 + l, 2.0)
        arrays.append(a)
    jst = [JState(**{k: jnp.asarray(v) for k, v in a.items()})
           for a in arrays]
    tg, tst = tfill.hierarchy_from_numpy(ts, [(s.lo, s.n) for s in specs],
                                         jg.parent, jg.depth, arrays)
    calls = []
    for mod, name in ((tcg, "mkflux_3d_fused"),
                      (tcg, "mkflux_update_3d_fused"), (tcu, "update_3d")):
        def spy(*a, _f=getattr(mod, name), _n=name, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    dt = 0.5 * min(jg.dx(1)) / 0.5
    step = ref_jit(lambda st: jadv.ml_advance(jg, st, dt, 4)[0])
    for _ in range(2):
        jst = step(jst)
        tst, diag = tadv.ml_advance(tg, tst, dt, 4)
        assert diag["mac_ratio"] <= 1.0 and diag["hg_ratio"] <= 1.0
    for a, b in zip(state_arrays(tst), state_arrays(jst)):
        for k in a:
            scale = max(1.0, float(np.abs(b[k]).max()))
            assert float(np.abs(a[k] - b[k]).max()) <= TOL * scale, k
    assert sorted(set(calls)) == ["mkflux_3d_fused", "update_3d"]
    assert calls.count("mkflux_3d_fused") == calls.count("update_3d") == 8
