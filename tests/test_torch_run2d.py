"""The port's single-level 2-D runs against varden_tpu's (float64, CPU).

Varden.run (initial projection, one pressure iteration, three steps) of
BASELINE configs 1 and 2 at 16^2 and of the Rayleigh-Taylor and advection
inputs files with max_levs 1 at 16^2, held to 1e-9 relative to each
field's size (three steps of solver tolerances 1e-10 / 1e-12); a run past
the scheme's viscous stability limit; and the CLI."""
import os
import subprocess
import sys

import numpy as np
import pytest

from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.config import load_config as jload
from varden_tpu.driver import Varden as JVarden
from varden_tpu_torch import problems as tprob
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.config import load_config as tload
from varden_tpu_torch.driver import Varden as TVarden
from varden_tpu_torch.state import Sim as TSim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALLS = dict(bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15)
FIELDS = ("u", "s", "gp", "p")


def _run_both(jcfg, tcfg, steps=3):
    jv, tv = JVarden(jcfg), TVarden(tcfg, device="cpu")
    js, ts = jv.run(), tv.run()
    assert tv.istep == jv.istep == steps
    assert abs(tv.time - jv.time) <= 1e-12 * jv.time
    assert abs(tv.dt - jv.dt) <= 1e-12 * jv.dt
    for k in FIELDS:
        a, b = getattr(ts, k).numpy(), np.array(getattr(js, k))
        scale = max(1.0, float(np.max(np.abs(b))))
        assert float(np.max(np.abs(a - b))) <= 1e-9 * scale, k
    return js, ts, tv


# BASELINE configs 1 (inviscid) and 2 (visc_coef 1e-3) at 16^2
@pytest.mark.parametrize("visc", [0.0, 1e-3], ids=["cfg1", "cfg2"])
def test_run_2d_bubble_matches_three_steps(visc, capsys):
    kw = dict(dim_in=2, prob_type=1, n_cellx=16, n_celly=16, grav=-9.8,
              visc_coef=visc, cflfac=0.9, dtype="float64", init_iter=1,
              max_step=3, plot_int=-1, chk_int=-1, verbose=1, **WALLS)
    js, ts, tv = _run_both(JCfg(**kw), TCfg(**kw))
    rho = ts.s[0]
    assert 1.0 - 1e-3 < float(rho.min()) and float(rho.max()) < 2.0 + 1e-3
    assert "new min/max : density" in capsys.readouterr().out
    assert ("visc_cycles" in tv.last_diag) == (visc > 0.0)


def test_run_2d_follows_the_reference_past_its_viscous_stability_limit():
    """The predictor takes the viscous term explicitly, so a run whose
    nu dt / dx^2 is near 100 (here 32^2 with visc_coef 1.4; the published
    viscous bubble would reach it at 4096^2) is unstable in varden_tpu: the
    density leaves [1, 2] on the second step. The port gives the same
    fields, so the blow-up is the scheme's and not the port's."""
    kw = dict(dim_in=2, prob_type=1, n_cellx=32, n_celly=32, grav=-9.8,
              visc_coef=1.4, cflfac=0.9, dtype="float64", init_iter=1,
              max_step=2, plot_int=-1, chk_int=-1, verbose=0, **WALLS)
    js, ts, tv = _run_both(JCfg(**kw), TCfg(**kw), steps=2)
    assert 1.4 * tv.dt * 32 * 32 > 100.0
    assert float(ts.s[0].min()) < 0.0 and float(np.array(js.s[0]).min()) < 0.0


@pytest.mark.parametrize("name", ["inputs_RayleighTaylor_2d",
                                  "inputs_advect_2d"])
def test_run_2d_inputs_files_match_three_steps(name):
    path = os.path.join(ROOT, "inputs", name)
    over = dict(max_levs=1, n_cellx=16, n_celly=16, max_step=3, plot_int=-1,
                chk_int=-1, dtype="float64")
    js, ts, _ = _run_both(jload(path, **over), tload(path, **over))
    assert float((ts.u - tprob.initdata(
        TSim(tload(path, **over), device="cpu")).u).abs().max()) > 1e-8


def test_cli_runs_the_2d_bubble_inputs_file(tmp_path):
    args = [sys.executable, "-m", "varden_tpu_torch",
            os.path.join("inputs", "inputs_bubble_2d"), "--max_levs", "1",
            "--plot_int", "-1", "--max_step", "4", "--device", "cpu"]
    env = dict(os.environ)
    env.pop("PROBIN", None)
    res = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "STEP =    4" in res.stdout and "Run time" in res.stdout
    dens = [ln.split() for ln in res.stdout.splitlines()
            if "new min/max : density" in ln]
    assert len(dens) == 4
    for parts in dens:
        lo, hi = float(parts[-2]), float(parts[-1])
        assert 1.0 - 1e-6 <= lo and hi <= 2.0 + 1e-6
    # plotfiles at plot_int, and one at the final step off the cadence
    base = str(tmp_path / "plt")
    res = subprocess.run(args[:-4] + ["--plot_int", "2", "--max_step", "3",
                                      "--plot_base_name", base, "--device",
                                      "cpu"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert sorted(os.listdir(tmp_path)) == ["plt00000", "plt00002",
                                            "plt00003"]
