"""The 2-D advection regression inputs (inputs/inputs_advect_2d: inlet at x
lo with u_bc 1, outlet at x hi, slip walls in y, two levels, regrid every 2
steps) at their shipped 64^2 base for 3 steps, across the step-3 regrid,
the port held to varden_tpu step by step (float64, CPU;
torch_inputs.hold_port_run): the initial hierarchy and data, the tree and
data of the regrid, and the last step within 1e-9 of each field's size.
Level 1 (64^2 at (32, 32), then 80^2 at (24, 24)) leaves the inlet face
uncovered; a base whose level 1 covers the domain (32^2) is the inlet
departure of ROADMAP.md section 3, which tests/test_torch_amr_inflow3d.py
holds with varden_tpu patched."""
import os

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import hold_port_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_advect_2d_two_levels_follows_varden_tpu():
    tv, ts, boxes = hold_port_run(
        os.path.join(ROOT, "inputs", "inputs_advect_2d"), max_step=3)
    assert len(ts) == 2 and tv.regrids >= 1 and len(boxes) == 3
    assert boxes[-1][1] == [((0, 0), (64, 64)), ((24, 24), (80, 80))]
