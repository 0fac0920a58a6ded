"""The 3-D regression inputs (inputs/inputs_3d-regt: the bubble, walls,
regrid every 2 steps) at a 16^3 base with two levels for three steps, the
port against varden_tpu (float64, CPU): a rebuilding or kept regrid at step
3, the same boxes, and every field of every patch at 1e-9 of its size."""
import os

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import assert_runs_agree, run_inputs_both

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_regt_3d_two_levels_across_a_regrid():
    runs = run_inputs_both(os.path.join(ROOT, "inputs", "inputs_3d-regt"),
                           n_cellx=16, n_celly=16, n_cellz=16, max_levs=2,
                           max_step=3)
    jv, tv, js, ts = runs
    assert tv.istep == 3 and tv.regrids >= 1 and len(ts) >= 2
    assert_runs_agree(*runs)
