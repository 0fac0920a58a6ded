"""The wall rows of the 3-D Rayleigh-Taylor inputs (inputs/inputs_RayleighTaylor_3d
on one level: periodic x and y, no-slip walls in z, visc_coef 1e-2), the
port against varden_tpu through the shadow helper of tests/torch_inputs.py
(float64, CPU, varden_tpu on its padded-sweep route as in
tests/test_torch_rt3d.py).

Once the falling heavy fluid reaches the bottom wall, the density in the
cell rows on the walls leaves [1, 2] much further than in the interior (at
64^3 the bottom row's minimum falls to 0.672 by step 110, the top row's
maximum rises to 2.079). varden_tpu does the same from the same state:
ROADMAP.md section 3 gives tools/torch_shadow.py's numbers at 32^3 and
64^3, both packages' whole runs equal to roundoff through the runaway.

At 16^3 the wall rows leave [1, 2] by step 33. The port's state at step 44
(its state, warm starts, time and dt) is saved in rt3d_16_step44.npz,
written by

    python tools/torch_shadow.py inputs/inputs_RayleighTaylor_3d \\
        --max_levs 1 --n_cellx 16 --n_celly 16 --n_cellz 16 --steps 44 \\
        --save tests/rt3d_16_step44.npz

From there the port runs to step 60, and at steps 45 and 60 varden_tpu's
step from the port's own state gives the port's to 1e-9 of each field's
size, after the same V-cycles, while the wall rows run away. The helper
also catches a port step that was perturbed."""
import os

import numpy as np
import pytest

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import RefStep, agree, field_deltas, row_ranges, \
    shadow_single
from varden_tpu.config import load_config as jload
from varden_tpu_torch import advance
from varden_tpu_torch.config import load_config as tload

HERE = os.path.dirname(os.path.abspath(__file__))
PATH = os.path.join(os.path.dirname(HERE), "inputs",
                    "inputs_RayleighTaylor_3d")
START = os.path.join(HERE, "rt3d_16_step44.npz")
OVER = dict(max_levs=1, n_cellx=16, n_celly=16, n_cellz=16, dtype="float64",
            plot_int=-1, chk_int=-1, verbose=0, mg_verbose=0)
HELD = (45, 60)


@pytest.fixture(scope="module")
def cfgs():
    return tload(PATH, **OVER), jload(PATH, **OVER)


@pytest.fixture(scope="module")
def ref(cfgs):
    return RefStep(cfgs[1])


@pytest.fixture(scope="module")
def runaway(cfgs, ref):
    return {r["step"]: r for r in shadow_single(
        cfgs, 60, shadow=HELD, whole=False, ref=ref, start=START)}


def test_wall_rows_leave_the_density_range_as_in_varden_tpu(cfgs, runaway):
    assert sorted(runaway) == list(range(45, 61))
    for step in HELD:
        rec = runaway[step]
        for k, d in rec["shadow"].items():
            assert d <= 1e-9, (step, k, d)
        cyc = rec["cycles"]
        assert [c for _n, c, _r in cyc["port"]] == \
            [c for _n, c, _r in cyc["shadow"]], step
        assert max(r for _n, _c, r in cyc["shadow"]) <= 1.0
    # the wall rows leave [1, 2] by far more than the interior does
    with np.load(START) as z:
        assert int(z["istep"]) == 44
        saved = row_ranges(z["s"][0], cfgs[0].pmask)
    assert saved["z=0"][1] > 2.05 and saved["interior"][0] > 0.99
    late = runaway[60]["port"]
    lo, hi = late["interior"]
    assert 0.99 < lo and hi < 2.02
    assert late["z=0"][1] > 2.1 and late["z=15"][0] < 0.95
    assert runaway[45]["port"]["z=0"][1] > 2.05


def test_shadow_catches_a_perturbed_port_step(cfgs, ref, monkeypatch):
    steps = []
    orig = advance.advance_timestep

    def perturbed(sim, state, dt, proj_type, hints=None):
        out, diag = orig(sim, state, dt, proj_type, hints=hints)
        if proj_type == advance.projection.REGULAR_TIMESTEP:
            steps.append(1)
            if len(steps) == 2:
                out.s[0, 3, 4, 0] += 1e-6
        return out, diag

    monkeypatch.setattr(advance, "advance_timestep", perturbed)
    recs = shadow_single(cfgs, 47, shadow=(45, 46, 47), whole=False,
                         ref=ref, start=START)
    assert len(steps) == 3
    worst = [max(r["shadow"].values()) for r in recs]
    assert worst[0] <= 1e-9 and worst[2] <= 1e-9
    # 1e-6 over the density's size, which lies in [2, 2.2] at these steps
    assert 1e-6 / 2.2 < recs[1]["shadow"]["s"] <= 1e-6 / 2.0


def test_row_ranges_names_the_wall_rows():
    rho = np.arange(4 * 5 * 6, dtype=float).reshape(4, 5, 6)
    rr = row_ranges(rho, (True, False, False))
    assert set(rr) == {"y=0", "y=4", "z=0", "z=5", "interior"}
    assert rr["z=5"] == (5.0, 119.0)
    assert rr["interior"] == (rho[:, 2:3, 2:4].min(), rho[:, 2:3, 2:4].max())


@pytest.mark.parametrize("side", ["ref", "port"])
@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_a_value_that_is_not_finite_never_agrees(side, bad):
    good = {"s": np.ones((2, 3)), "u": np.zeros((2, 3))}
    broken = {"s": np.ones((2, 3)), "u": np.zeros((2, 3))}
    broken["s"][1, 2] = bad
    got, want = ([broken], [good]) if side == "port" else ([good], [broken])
    for order in (slice(None), slice(None, None, -1)):
        d = field_deltas((got + [good])[order], (want + [good])[order])
        assert d["s"] == np.inf and d["u"] == 0.0
    with pytest.raises(AssertionError):
        agree(got, want, 1e-9)
