"""The 2-D Rayleigh-Taylor regression inputs (inputs/inputs_RayleighTaylor_2d:
periodic x, no-slip walls in y, three levels, regrid every 2 steps) at a
32^2 base for 3 steps, across the step-3 regrid, the port held to
varden_tpu step by step (float64, CPU; torch_inputs.hold_port_run): the
initial hierarchy and data, the tree and data of the regrid, and the last
step within 1e-9 of each field's size. Its patches span the periodic axis,
so the coarse-fine fills and composite solves wrap across x."""
import os

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import hold_port_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_rt_2d_three_levels_follows_varden_tpu():
    tv, ts, boxes = hold_port_run(
        os.path.join(ROOT, "inputs", "inputs_RayleighTaylor_2d"),
        n_cellx=32, n_celly=32, max_step=3)
    assert len(ts) == 3 and tv.regrids >= 1 and len(boxes) == 3
    assert all(b[0][1] == (32, 32) for _, b in boxes)
    assert all(b[1][1][0] == 64 for _, b in boxes)  # spans periodic x
