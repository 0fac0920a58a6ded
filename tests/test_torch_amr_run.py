"""The port's multi-level runs. Varden.run of the 2-D bubble (16^2 base,
max_levs 2, regrid_int 2, visc_coef 1e-3: initial projection, one pressure
iteration, three steps, a regrid at step 3) against varden_tpu's (float64,
CPU) at 1e-9 of each field's size, with equal boxes; and the port's CLI
alone on the 3-D regression inputs at 16^3 with two levels; then the same
inputs against varden_tpu across a regrid. They sit in this file,
beside its other tests, because pytest-xdist's --dist loadfile hands the
files out by their number of tests, most first: a file of few heavy tests
would start last and make the run's tail."""
import os
import re
import subprocess
import sys

import numpy as np

from torch_inputs import state_arrays, one_torch_thread  # noqa: F401
from torch_inputs import assert_runs_agree, run_inputs_both
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.driver import Varden as JVarden
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.driver import Varden as TVarden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_run_ml_2d_matches_across_a_regrid(capsys):
    kw = dict(dim_in=2, prob_type=1, n_cellx=16, n_celly=16, max_levs=2,
              regrid_int=2, grav=-9.8, visc_coef=1e-3, cflfac=0.9,
              init_shrink=0.1, init_iter=1, max_step=3, dtype="float64",
              plot_int=-1, chk_int=-1, verbose=0, bcx_lo=15, bcx_hi=15,
              bcy_lo=15, bcy_hi=15)
    jv, tv = JVarden(JCfg(**kw)), TVarden(TCfg(**kw), device="cpu")
    js, ts = jv.run(), tv.run()
    assert tv.istep == jv.istep == 3 and tv.regrids == 1
    assert abs(tv.time - jv.time) <= 1e-12 * jv.time
    assert [(s.lo, s.n) for s in tv.geom.specs] == \
        [(s.lo, s.n) for s in jv.geom.specs]
    assert tv.geom.parent == jv.geom.parent
    for a, b in zip(state_arrays(ts), state_arrays(js)):
        for k in a:
            scale = max(1.0, float(np.abs(b[k]).max()))
            assert float(np.abs(a[k] - b[k]).max()) <= 1e-9 * scale, k
    assert "regrid: kept" in capsys.readouterr().out


def test_cli_runs_the_3d_regression_inputs_with_two_levels():
    # one thread: a 16^3 run is far quicker without the thread pool's
    # contention with the other test processes
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PROBIN", None)
    res = subprocess.run(
        [sys.executable, "-m", "varden_tpu_torch", "inputs/inputs_3d-regt",
         "--n_cellx", "16", "--n_celly", "16", "--n_cellz", "16",
         "--max_levs", "2", "--max_step", "3", "--plot_int", "-1",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert re.search(r"STEP =\s+3 .*levels: \[\(16, 16, 16\), .*regrid:", out)
    rho = [(float(a), float(b)) for a, b in re.findall(
        r"new min/max : density\s+(\S+)\s+(\S+)", out)]
    assert len(rho) == 3
    assert all(1.0 - 1e-4 <= lo and hi <= 10.0 + 1e-4 for lo, hi in rho)


def test_step_ml_chunk_equals_single_steps():
    """k steps in one step_ml_chunk are k regular step_ml calls (no regrid
    inside; the port's own plain path)."""
    kw = dict(dim_in=2, prob_type=1, n_cellx=16, n_celly=16, max_levs=2,
              regrid_int=-1, grav=-9.8, visc_coef=1e-3, cflfac=0.9,
              init_shrink=0.1, init_iter=1, dtype="float64", plot_int=-1,
              chk_int=-1, bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15)
    runs = []
    for chunk in (False, True):
        v = TVarden(TCfg(**kw), device="cpu")
        st = v.step_ml(v.initialize_ml())
        if chunk:
            st = v.step_ml_chunk(st, 2)
        else:
            st = v.step_ml(v.step_ml(st))
        runs.append((v, st))
    (va, sa), (vb, sb) = runs
    assert va.istep == vb.istep == 3 and va.time == vb.time
    for a, b in zip(state_arrays(sa), state_arrays(sb)):
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_regt_3d_two_levels_across_a_regrid():
    """The 3-D regression inputs (inputs/inputs_3d-regt: the bubble, walls,
    regrid every 2 steps) at a 16^3 base with two levels for three steps,
    the port against varden_tpu (float64, CPU): a rebuilding or kept regrid
    at step 3, the same boxes, and every field of every patch at 1e-9 of
    its size."""
    runs = run_inputs_both(os.path.join(ROOT, "inputs", "inputs_3d-regt"),
                           n_cellx=16, n_celly=16, n_cellz=16, max_levs=2,
                           max_step=3)
    jv, tv, js, ts = runs
    assert tv.istep == 3 and tv.regrids >= 1 and len(ts) >= 2
    assert_runs_agree(*runs)
