"""BASELINE config 4's geometry (3-D Rayleigh-Taylor, periodic in x and y,
no-slip walls in z, visc_coef 1e-3, cflfac 0.9; bench.py:303-307) against
varden_tpu, float64, CPU.

Varden.run at 16^3 with one pressure iteration and two steps: varden_tpu
with its accelerator route to the padded red-black sweep forced (every
periodic-x MAC level of even extents >= 8 smooths with
pallas_kernels.gsrb_sweep_3d, in interpret mode), the port taking the same
route through its plain version. Tolerances those of
tests/test_torch_driver.py: 1e-9 of each field's size, 1e-12 in time and
dt. The density leaves [1, 2] on this coarse grid (min 0.972708, max
2.006152 after two steps): that overshoot is the reference's own, and both
packages reach it to 1e-9.

Then the RT inputs' hierarchy at a 16^3 base (two levels): the same
patches, initial data and padded ghosts (a patch spanning the periodic x
and y axes wraps) as varden_tpu's, to 1e-12."""
import jax.numpy as jnp
import numpy as np
import pytest

from torch_inputs import force_padded_route, one_torch_thread  # noqa: F401
from torch_inputs import ref_jit, state_arrays
from varden_tpu.amr import fill as jfill
from varden_tpu.amr import regrid as jreg
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.driver import Varden as JVarden
from varden_tpu.state import Sim as JSim
from varden_tpu_torch.amr import fill as tfill
from varden_tpu_torch.amr import regrid as treg
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.driver import Varden as TVarden
from varden_tpu_torch.ops import cuda_kernels as tck
from varden_tpu_torch.state import Sim as TSim

# config 4 as bench.py:303-307 sets it, at 16^3, float64, one pressure
# iteration, two steps
KW = dict(dim_in=3, prob_type=3, n_cellx=16, n_celly=16, n_cellz=16,
          grav=-9.8, visc_coef=1e-3, cflfac=0.9, dtype="float64",
          bcx_lo=-1, bcx_hi=-1, bcy_lo=-1, bcy_hi=-1, bcz_lo=15, bcz_hi=15,
          init_iter=1, max_step=2, plot_int=-1, chk_int=-1)


def test_config4_follows_the_accelerator_route(monkeypatch):
    jcalls = force_padded_route(monkeypatch)
    tcalls = []
    sweep = tck.gsrb_sweep_3d

    def counted(*a, **k):
        tcalls.append(1)
        return sweep(*a, **k)

    monkeypatch.setattr(tck, "gsrb_sweep_3d", counted)
    jv, tv = JVarden(JCfg(**KW)), TVarden(TCfg(**KW), device="cpu")
    js, ts = jv.run(), tv.run()
    assert jcalls and tcalls
    assert tv.istep == jv.istep == 2
    assert abs(tv.time - jv.time) <= 1e-12 * jv.time
    assert abs(tv.dt - jv.dt) <= 1e-12 * jv.dt
    for k in ("u", "s", "gp", "p"):
        a, b = getattr(ts, k).numpy(), np.array(getattr(js, k))
        scale = max(1.0, float(np.max(np.abs(b))))
        assert float(np.max(np.abs(a - b))) <= 1e-9 * scale, k
    rho_j, rho_t = np.array(js.s[0]), ts.s[0].numpy()
    for f in (np.min, np.max):
        assert abs(float(f(rho_t)) - float(f(rho_j))) <= 1e-9
    assert abs(float(rho_j.min()) - 0.972708) < 5e-7
    assert abs(float(rho_j.max()) - 2.006152) < 5e-7


def test_rt_hierarchy_matches():
    kw = dict(KW, max_levs=2, regrid_int=1, visc_coef=0.01)
    js, ts = JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")
    jg, jst = jreg.initialize_adaptive(js)
    tg, tst = treg.initialize_adaptive(ts)
    assert [(s.lo, s.n) for s in tg.specs] == \
        [(tuple(s.lo), tuple(s.n)) for s in jg.specs]
    assert tg.parent == jg.parent and tg.depth == jg.depth
    assert tg.ndepth == 2
    for a, b in zip(state_arrays(tst), state_arrays(jst)):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12)
    for lev in range(tg.nlev):
        assert tg.pmask_level(lev) == [jg.side_kind(lev, d, 0) == "per"
                                       for d in range(3)]
        assert tg.ell_bc_level(lev, 0) == jg.ell_bc_level(lev, 0)
    want = ref_jit(lambda u: [jfill.pad_ml_multi(jg, u, [0, 1, 2], lev, 3)
                              for lev in range(jg.nlev)])(
        [jnp.asarray(a["u"]) for a in state_arrays(jst)])
    for lev in range(tg.nlev):
        got = tfill.pad_ml_multi(tg, [st.u for st in tst], [0, 1, 2], lev, 3)
        assert float(np.max(np.abs(got.numpy() - np.asarray(want[lev])))) \
            <= 1e-12


@pytest.mark.parametrize("level", [0, 1])
def test_rt_tagging_matches(level):
    from varden_tpu import problems as jprob
    from varden_tpu_torch import problems as tprob
    js, ts = JSim(JCfg(**KW)), TSim(TCfg(**KW), device="cpu")
    rho = np.array(jprob.initdata(js).s[0])
    want = np.asarray(jprob.tag_cells(js, jnp.asarray(rho), level))
    got = tprob.tag_cells(ts, tprob.initdata(ts).s[0], level).numpy()
    assert np.array_equal(got, want) and want.any()
