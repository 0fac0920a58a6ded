"""The multi-level shadow helper of tests/torch_inputs.py (hold_port_run with
chosen steps and a report), on the 2-D Rayleigh-Taylor inputs
(inputs/inputs_RayleighTaylor_2d: periodic x, no-slip walls in y) at a 16^2
base with two levels, float64, CPU: varden_tpu's ml_advance from the port's
state of each step gives the port's step to 1e-9 of each field's size, and
a port step perturbed by 1e-6 in one density cell is caught at that step
alone (the next step starts from the port's perturbed state)."""
import os

import pytest

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import hold_port_run, row_ranges
from varden_tpu_torch import projection
from varden_tpu_torch.amr import advance_ml as tadv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_hold_port_run_reports_chosen_steps_and_catches_a_perturbation(
        monkeypatch):
    calls, seen = [], {}
    orig = tadv.ml_advance

    def perturbed(geom, states, dt, proj_type, hints=None):
        out = orig(geom, states, dt, proj_type, hints=hints)
        if proj_type == projection.REGULAR_TIMESTEP:
            calls.append(1)
            if len(calls) == 2:
                out[0][-1].s[0, 5, 7] += 1e-6
        return out

    def report(step, deltas, got, ref, geom):
        seen[step] = (deltas, [
            row_ranges(g["s"][0], (True, False), s.lo,
                       [16 * 2 ** d, 16 * 2 ** d])
            for g, s, d in zip(got, geom.specs, geom.depth)])

    monkeypatch.setattr(tadv, "ml_advance", perturbed)
    tv, ts, boxes = hold_port_run(
        os.path.join(ROOT, "inputs", "inputs_RayleighTaylor_2d"),
        at=(1, 2, 3), report=report, n_cellx=16, n_celly=16, max_levs=2,
        max_step=3)
    assert len(ts) == 2 and len(calls) == 3 and sorted(seen) == [1, 2, 3]
    assert max(seen[1][0].values()) <= 1e-9
    assert max(seen[3][0].values()) <= 1e-9
    assert seen[2][0]["s"] == pytest.approx(1e-6 / 2.0, rel=1e-3)
    base, fine = seen[1][1]
    assert set(base) == {"y=0", "y=15", "interior"}
    # the fine level covers the domain: its wall rows named on its level
    assert set(fine) == {"y=0", "y=31", "interior"}
