"""Single-level 3-D inputs files that no other test steps, the port against
varden_tpu (float64, CPU, 16^3), at 1e-9 of each field's size and 1e-12 in
time: the vortex tube (fully periodic, visc_coef 1e-3) for two steps, with
varden_tpu's accelerator route to the padded red-black sweep forced (as
tests/test_torch_rt3d.py forces it), and the 3-D advection inputs (inlet at
x lo, outlet at x hi, walls in y and z) for three steps."""
import os

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import assert_runs_agree, force_padded_route, \
    run_inputs_both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N16 = dict(n_cellx=16, n_celly=16, n_cellz=16)


def test_periodic_vortex_tube_follows_the_accelerator_route(monkeypatch):
    calls = force_padded_route(monkeypatch)
    runs = run_inputs_both(os.path.join(ROOT, "inputs", "inputs_vortextube_3d"),
                           max_step=2, **N16)
    assert calls and runs[1].istep == 2
    assert_runs_agree(*runs)


def test_advect_3d_inlet_outlet_single_level():
    runs = run_inputs_both(os.path.join(ROOT, "inputs", "inputs_advect_3d"),
                           max_levs=1, max_step=3, **N16)
    assert runs[1].istep == 3
    assert_runs_agree(*runs)
