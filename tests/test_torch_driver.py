"""The port's driver and CLI: Varden.run of the 3-D bubble at 16^3, inviscid
(here) and viscous (viscous_run_matches, which test_torch_driver_viscous.py
and _krylov.py run), against varden_tpu's (float64, CPU; initial
projection, one pressure iteration, three steps), and the CLI on an inputs
file. Tolerance 1e-9 relative to
each field's size: both packages take the same dt sequence and V-cycle
counts, and the solvers converge to rel_eps 1e-10 / 1e-12; the viscous
Helmholtz solve (rel_eps 1e-12, Jacobi sweeps in varden_tpu on the CPU,
red-black in the port) adds at most 2e-12 of the velocity per step."""
import os
import subprocess
import sys

import numpy as np
import pytest

from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.driver import Varden as JVarden
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.driver import Varden as TVarden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(dim_in=3, prob_type=1, n_cellx=16, n_celly=16, n_cellz=16,
          grav=-9.8, dtype="float64", bcx_lo=15, bcx_hi=15, bcy_lo=15,
          bcy_hi=15, bcz_lo=15, bcz_hi=15, cflfac=0.5, init_iter=1,
          max_step=3, plot_int=-1, chk_int=-1, verbose=1)


def _run_both(kw):
    jv, tv = JVarden(JCfg(**kw)), TVarden(TCfg(**kw), device="cpu")
    js, ts = jv.run(), tv.run()
    assert tv.istep == jv.istep == 3
    assert abs(tv.time - jv.time) <= 1e-12 * jv.time
    assert abs(tv.dt - jv.dt) <= 1e-12 * jv.dt
    for k in ("u", "s", "gp", "p"):
        a, b = getattr(ts, k).numpy(), np.array(getattr(js, k))
        scale = max(1.0, float(np.max(np.abs(b))))
        assert float(np.max(np.abs(a - b))) <= 1e-9 * scale, k
    return js, ts


def test_run_matches_three_steps(capsys):
    js, ts = _run_both(KW)
    # density stays in [1, densfact=10] up to the advection undershoot that
    # the reference itself shows at this coarse 16^3 grid (about 2e-4)
    rho_j = np.array(js.s[0])
    lo, hi = min(1.0, rho_j.min()), max(10.0, rho_j.max())
    assert lo > 1.0 - 1e-3 and hi < 10.0 + 1e-3
    assert lo - 1e-12 <= float(ts.s[0].min()) <= float(ts.s[0].max()) \
        <= hi + 1e-12
    assert "new min/max : density" in capsys.readouterr().out


# the headline configuration's viscosity (Crank-Nicolson, dense bottoms),
# and backward Euler with tracer diffusion and the Krylov bottom solvers:
# one test file each (test_torch_driver_viscous.py, _krylov.py), so that
# --dist loadfile spreads them
VISCOUS_RUNS = {
    "headline": dict(visc_coef=1e-3),
    "be-krylov": dict(visc_coef=1e-2, diff_coef=1e-2, diffusion_type=2,
                      mg_bottom_solver=2, hg_bottom_solver=1)}


def viscous_run_matches(extra):
    """The body of test_viscous_run_matches_three_steps."""
    js, ts = _run_both(dict(KW, **extra))
    inviscid = TVarden(TCfg(**KW), device="cpu").run()
    assert float((ts.u - inviscid.u).abs().max()) > 1e-7


@pytest.mark.parametrize("device", ["cpu", None])
def test_cli_runs_an_inputs_file(device):
    args = [sys.executable, "-m", "varden_tpu_torch",
            os.path.join("inputs", "inputs_bubble_3d"), "--max_levs", "1",
            "--n_cellx", "16", "--n_celly", "16", "--n_cellz", "16",
            "--max_step", "1", "--plot_int", "-1"]
    if device is not None:
        args += ["--device", device]
    env = dict(os.environ)
    env.pop("PROBIN", None)
    res = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    if device == "cpu":
        assert res.returncode == 0, res.stdout + res.stderr
        assert "STEP =    1" in res.stdout and "Run time" in res.stdout
    else:  # no card here: the default device must refuse, not fall back
        assert res.returncode != 0
        assert "device='cpu'" in res.stderr
