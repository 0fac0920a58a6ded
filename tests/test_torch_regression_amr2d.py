"""The 2-D regression inputs with four levels (inputs/inputs_2d-regt: the
bubble in a box with walls, regrid every 2 steps) at a 32^2 base for 4
steps, across the step-3 regrid, the port held to varden_tpu step by step
(float64, CPU; torch_inputs.hold_port_run): the initial hierarchy and
data, the tree and data of the regrid, and the last step within 1e-9 of
each field's size (varden_tpu pins this hierarchy's depth only in its own
golden case, bubble-2d-ml4)."""
import os

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import hold_port_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bubble_2d_four_levels_follows_varden_tpu():
    tv, ts, boxes = hold_port_run(
        os.path.join(ROOT, "inputs", "inputs_2d-regt"), n_cellx=32,
        n_celly=32, max_step=4)
    assert len(ts) == 4 and tv.regrids >= 1 and len(boxes) == 4
    assert all(len(b) == 4 for _, b in boxes)
