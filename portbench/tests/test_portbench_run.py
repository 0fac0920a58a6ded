"""The harness driven end to end on the CPU at a size a test run holds (the
look for a card skipped: ``device="cpu"``), with the cells' own limits:
a sound run is correct, and each fault of the timed path that a cell can
have, and the float32 control, come out not correct."""
import copy
import json
import os

import pytest
import torch

from portbench import cell as cell_mod
from portbench import harness

N = 16


def tiny(name, n=N):
    """The cell ``name`` at n^3 cells a level, checking one of its first
    two window steps and tracing two."""
    c = cell_mod.resolve(name)
    c.traffic = copy.deepcopy(c.traffic)
    c.traffic["settings"].update(n_cellx=n, n_celly=n, n_cellz=n)
    c.traffic.update(check_steps=2, trace_steps=2)
    return c


def go(c, traced=False, dtype=None, seed=2 ** 31 + 7):
    return harness.run(c, seed, 0.5, traced, device="cpu", dtype=dtype)


def numbers(out):
    return {k: v["value"] for k, v in out["compared"].items()}


@pytest.mark.parametrize("name", ["bubble3d.l1-256", "rt3d.l1-256"])
def test_sound_run_is_correct(name):
    out = go(tiny(name))
    assert out["correct"], numbers(out)
    assert out["attempted"] >= 1
    assert list(out)[-1] == "compared"
    assert {"cells_per_s", "setup_s", "peak_mem_gib"} <= set(out["metrics"])


@pytest.mark.parametrize("name", ["bubble3d.l1-256", "rt3d.l1-256"])
def test_control_float32_is_not_correct(name):
    out = go(tiny(name), dtype="float32")
    assert not out["correct"], numbers(out)


def _broken_advance(monkeypatch, module, attr, fault):
    """Break the port's timestep underneath Varden: regular steps
    return the state unchanged, or one value of the new velocity altered."""
    real = getattr(module, attr)
    from varden_tpu_torch import projection

    def broken(geom_or_sim, state, dt, proj_type, hints=None):
        new, diag = real(geom_or_sim, state, dt, proj_type, hints=hints)
        if proj_type != projection.REGULAR_TIMESTEP:
            return new, diag
        if fault == "unchanged":
            return state, diag
        levels = new if isinstance(new, list) else [new]
        u = levels[-1].u
        idx = tuple(s // 2 for s in u.shape)
        u[idx] += 1e-6 * float(u.abs().max())
        return new, diag

    monkeypatch.setattr(module, attr, broken)


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_faults_single_level_are_not_correct(monkeypatch, fault):
    from varden_tpu_torch import advance
    _broken_advance(monkeypatch, advance, "advance_timestep", fault)
    out = go(tiny("bubble3d.l1-256"))
    assert not out["correct"], numbers(out)
    assert numbers(out)["start.u"] == 0.0


def tiny_amr(n=N):
    """The bubble on BASELINE config 5's hierarchy (traffic/amr3-256.json)
    at an n^3 base, held to the single-level bubble's limits."""
    c = tiny("bubble3d.l1-256", n)
    with open(os.path.join(cell_mod.HERE, "traffic", "amr3-256.json")) as fh:
        c.traffic = json.load(fh)
    c.traffic["settings"].update(n_cellx=n, n_celly=n, n_cellz=n)
    c.traffic.update(check_steps=2, trace_steps=2)
    c.limits = dict(c.limits, hierarchy=0.0)
    return c


def test_amr_sound_and_unchanged_step(monkeypatch):
    c = tiny_amr()
    assert c.multilevel
    out = go(c)
    assert out["correct"], numbers(out)
    assert numbers(out)["hierarchy"] == 0.0
    from varden_tpu_torch.amr import advance_ml
    _broken_advance(monkeypatch, advance_ml, "ml_advance", "unchanged")
    out = go(c)
    assert not out["correct"], numbers(out)


def test_traced_run_reports_per_layer_metrics():
    out = go(tiny("rt3d.l1-256"), traced=True)
    assert out["correct"], numbers(out)
    m = out["metrics"]
    assert m["vcycles_per_step"]["value"] > 0
    assert m["part_ms.macproject"]["value"] > 0
    assert m["part_ms.hgproject"]["value"] > 0
    # no device on the CPU: the kernels' readers find nothing to read
    assert "godunov_roofline" not in m and "smoother_ms_per_step" not in m
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_step_leaves_its_input_unmodified():
    """The harness holds the checked step's input by reference until the
    step returns: the port must not write into it."""
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.driver import Varden
    c = tiny("rt3d.l1-256")
    v = Varden(VardenConfig(**c.settings()), device="cpu")
    st = harness.initial_states(harness.Port(), v, c, 5, torch.device("cpu"))
    st = [v.step(st[0])]
    held = (st[0], harness._hints(v))
    copies = ({f: getattr(st[0], f).clone() for f in "u s gp p".split()},
              {k: t.clone() for k, t in held[1].items()})
    v.step(st[0])
    for f, t in copies[0].items():
        assert torch.equal(getattr(held[0], f), t)
    for k, t in copies[1].items():
        assert torch.equal(held[1][k], t)
