"""The Godunov debug oracle and the profiler's phases on a single level
decomposed over 2 gloo ranks (1x2) on the CPU, against the one-rank run:
the viscous 3-D bubble at 16^3 with use_godunov_debug, each phase of
profiling.phase_fns (premac's and mac's faces, scalar's snew, hg's
velocity) on one seeded state and two steps of the oracle's route (the
ranks pass the level's max|u| to the oracle, so that its tie epsilon is
the level's), every field within 1e-10 of its size. The ranks run
tests/torch_decomp_cases.py (case_debug) through
varden_tpu_torch.parallel.launch."""
import numpy as np
import pytest
import torch

import torch_decomp_cases as cases
from torch_inputs import one_torch_thread  # noqa: F401
from varden_tpu_torch.parallel import launch

TOL = 1e-10


@pytest.fixture(scope="module")
def runs():
    two = launch.spawn(cases.run_batch, 2, ["debug"], timeout=240.0)[0]
    torch.set_default_dtype(torch.float64)
    try:
        one = cases.run_case(1, "debug")
    finally:
        torch.set_default_dtype(torch.float32)
    return one, two["debug"]


def _close(a, b, what):
    assert a.shape == b.shape, what
    assert np.isfinite(a).all(), what
    scale = max(1.0, float(np.abs(b).max()))
    assert float(np.abs(a - b).max()) <= TOL * scale, what


def test_debug_phases_and_steps_on_two_ranks(runs):
    one, two = runs
    for ph in ("premac", "mac"):
        for d in range(3):
            _close(two[ph][d], one[ph][d], f"{ph} face {d}")
    for ph in ("scalar", "hg"):
        _close(two[ph], one[ph], ph)
    for k in ("u", "s", "gp", "p"):
        _close(two["steps"][k], one["steps"][k], f"steps {k}")
    assert two["keys"] == one["keys"] == [
        "Velocity update (premac)", "MAC Projection", "Scalar update",
        "HG Projection"]
