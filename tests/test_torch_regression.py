"""The port's regression harness (varden_tpu_torch/regression.py) against
run_regression.py: the same workload table (read from the file with ast:
importing it sets JAX's global config), the same configs as varden_tpu's
loader gives for every workload in quick and full mode, each runner passing
on the CPU at a tiny size, and each check failing on a state that breaks
it. Then the hierarchies that the suite reaches, the port held to
varden_tpu step by step (torch_inputs.hold_port_run): the 2-D regression
inputs with four levels, the 2-D Rayleigh-Taylor inputs with three and the
2-D advection inputs with two, each across a regrid. They sit in this file,
beside its many cheap tests, because pytest-xdist's --dist loadfile hands
the files out by their number of tests, most first: a file of one heavy
test would start last and make the run's tail."""
import ast
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import hold_port_run
from varden_tpu.config import load_config as jload
from varden_tpu_torch import regression as reg
from varden_tpu_torch.state import State

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = os.path.join(ROOT, "run_regression.py")


def _harness_tree():
    with open(HARNESS) as f:
        return ast.parse(f.read())


def _harness_workloads():
    for node in _harness_tree().body:
        if isinstance(node, ast.Assign) and \
                [t.id for t in node.targets] == ["WORKLOADS"]:
            return ast.literal_eval(node.value)
    raise AssertionError("run_regression.py has no WORKLOADS table")


def _harness_fn(name):
    """run_regression.py's own function ``name``, compiled from its source
    with varden_tpu's load_config, numpy, and the file's table and inputs
    directory."""
    fn = next(n for n in _harness_tree().body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"os": os, "np": np, "load_config": jload,
          "WORKLOADS": _harness_workloads(),
          "INPUTS": os.path.join(ROOT, "inputs")}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), HARNESS, "exec"), ns)
    return ns[name]


def test_workload_table_equals_the_harness():
    assert reg.WORKLOADS == _harness_workloads()
    assert list(reg.RUNNERS) == list(reg.WORKLOADS)
    assert os.path.samefile(reg.INPUTS, os.path.join(ROOT, "inputs"))


@pytest.mark.parametrize("full", [False, True], ids=["quick", "full"])
@pytest.mark.parametrize("name", list(reg.WORKLOADS))
def test_load_equals_the_harness_field_by_field(name, full):
    port, ref = reg._load(name, full), _harness_fn("_load")(name, full)
    for f in dataclasses.fields(ref):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert {f.name for f in dataclasses.fields(port)} == \
        {f.name for f in dataclasses.fields(ref)}


# each runner at a tiny size on the CPU: (overrides, levels at the end)
TINY = {
    "bubble-2d": (dict(n_cellx=32, n_celly=32, max_step=3), 4),
    "bubble-3d": (dict(n_cellx=16, n_celly=16, n_cellz=16, max_levs=2,
                       max_step=2), 2),
    "bubble-restart": (dict(n_cellx=16, n_celly=16, n_cellz=16, max_levs=2,
                            max_step=6), 2),
    "advect-2d": (dict(n_cellx=16, n_celly=16, max_step=3), 2),
    "advect-3d": (dict(n_cellx=16, n_celly=16, n_cellz=16, max_levs=2,
                       max_step=2), 2),
    "rt-2d": (dict(n_cellx=16, n_celly=16, max_step=2), 3),
    # no cell tagged at 8^3: a one-level hierarchy (its batched viscous
    # solve is test_torch_regression_rt3d.py's case)
    "rt-3d": (dict(n_cellx=8, n_celly=8, n_cellz=8, max_step=2,
                   init_iter=1), 1),
    "vortex-3d": (dict(n_cellx=8, n_celly=8, n_cellz=8, max_step=2), 1),
}


# the checks that fail in run_regression.py as in the port (ROADMAP.md
# section 3)
FAILS_AS_SHIPPED = {"advect-3d": "level 0 rho overshoot"}


@pytest.mark.parametrize("name", list(reg.WORKLOADS))
def test_runner_passes_on_the_cpu_at_a_tiny_size(name):
    over, nlev = TINY[name]
    if name in FAILS_AS_SHIPPED:
        with pytest.raises(reg.CheckFailed, match=FAILS_AS_SHIPPED[name]) \
                as e:
            reg.run_workload(name, device="cpu", verbose=0, **over)
        assert e.value.numbers["steps"] == over["max_step"]
        assert e.value.numbers["rho"][0][1] > 2.02
        assert e.value.numbers["wall_s"] > 0.0
        return
    out = reg.run_workload(name, device="cpu", verbose=0, **over)
    assert out["steps"] == over["max_step"]
    assert len(out["levels"]) == nlev
    assert out["wall_s"] > 0.0 and out["s_per_step"] > 0.0
    assert np.isfinite(out["div_after"])
    if name == "bubble-restart":
        assert out["bitwise"] and out["steps_run"] == over["max_step"] + \
            over["max_step"] - 4
    if name == "advect-2d":
        assert abs(out["centroid_shift"] / out["expected_shift"] - 1) < 0.3


def test_main_runs_a_workload_and_refuses_without_a_card(capsys,
                                                         monkeypatch):
    monkeypatch.setattr(reg, "WORKLOADS", dict(
        reg.WORKLOADS, **{"vortex-3d": ("inputs_vortextube_3d", dict(
            n_cellx=8, n_celly=8, n_cellz=8, max_step=1))}))
    assert reg.main(["vortex-3d", "--device", "cpu", "--dtype",
                     "float32"]) == 0
    out = capsys.readouterr().out
    assert "=== vortex-3d (inputs_vortextube_3d, quick) ===" in out
    assert "1 steps" in out and "on the CPU" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        reg.main(["vortex-3d"])


# ---------------------------------------------------------------------------
# each check shown to fail
# ---------------------------------------------------------------------------

def _state(n=(4, 4), rho=1.5, u=0.1):
    dm = len(n)
    return State(u=torch.full((dm,) + n, u, dtype=torch.float64),
                 s=torch.full((2,) + n, rho, dtype=torch.float64),
                 gp=torch.zeros((dm,) + n, dtype=torch.float64),
                 p=torch.zeros(tuple(k + 1 for k in n), dtype=torch.float64))


def _driver(n=(4, 4), div_after=1e-12):
    cfg = types.SimpleNamespace(dm=len(n), n_cell=n)
    return types.SimpleNamespace(istep=3, time=0.1, geom=None, cfg=cfg,
                                 last_diag={"div_after": div_after})


def test_check_passes_the_bubble_range():
    out = reg._check(_driver(), [_state(), _state(rho=1.99)], 2.0)
    assert out["rho"] == [(1.5, 1.5), (1.99, 1.99)]
    assert out["steps"] == 3 and out["levels"] == [((0, 0), (4, 4))]


@pytest.mark.parametrize("what,match", [
    ("over", "overshoot"), ("under", "undershoot"), ("nan_u", "not finite"),
    ("nan_rho", "undershoot")])
def test_check_fails(what, match):
    st = _state()
    # 2% of the jump of densfact 2 is 0.02: just outside it either way
    if what == "over":
        st.s[0, 1, 2] = 2.0 + 0.0201
    elif what == "under":
        st.s[0, 3, 0] = 1.0 - 0.0201
    elif what == "nan_u":
        st.u[1, 0, 0] = float("inf")
    else:
        st.s[0, 0, 0] = float("nan")
    with pytest.raises(reg.CheckFailed, match=match) as e:
        reg._check(_driver(), [_state(), st], 2.0)
    assert e.value.numbers["rho"][0] == (1.5, 1.5)
    assert e.value.numbers["steps"] == 3


@pytest.mark.parametrize("what", ["over", "under", "nan", "still"])
def test_rt_check_fails(what):
    st = _state()
    if what == "over":
        st.s[0, 2, 2] = 2.0201
    elif what == "under":
        st.s[0, 2, 2] = 0.9799
    elif what == "nan":
        st.s[0, 2, 2] = float("nan")
    else:
        st = _state(u=0.0)
    with pytest.raises(reg.CheckFailed):
        reg._rt_check(_driver(), [st], "rt")
    assert reg._rt_check(_driver(), [_state()], "rt")["ke"] == \
        pytest.approx(2 * 16 * 0.01)


def test_centroid_and_advection_check():
    rho = torch.ones(16, 8, dtype=torch.float64)
    rho[5] = 2.0
    assert reg._centroid_x(rho) == 5.5
    reg._advect_shift(dict(centroid_shift=0.1, expected_shift=0.1))
    for shift in (0.069, 0.131, -0.1):
        out = dict(centroid_shift=shift, expected_shift=0.1)
        with pytest.raises(reg.CheckFailed, match="blob moved") as e:
            reg._advect_shift(out)
        assert e.value.numbers is out


@pytest.mark.parametrize("what,match", [
    ("drift", "drifted"), ("ke", "KE grew"), ("div", "div_after")])
def test_vortex_check_fails(what, match):
    n = (4, 4, 4)
    st = _state(n, rho=1.0, u=0.1)
    ke0 = float((st.u ** 2).sum())
    v = _driver(n)
    assert reg._vortex_check(v, ke0, st)["drift"] == 0.0
    if what == "drift":
        st.s[0, 1, 1, 1] += 2.01e-4
    elif what == "ke":
        st.u *= 1.005
    else:
        v = _driver(n, div_after=1e-6 * 64)
    with pytest.raises(reg.CheckFailed, match=match) as e:
        reg._vortex_check(v, ke0, st)
    assert e.value.numbers["ke0"] == ke0


@pytest.mark.parametrize("field", ["u", "s", "gp", "p"])
def test_restart_check_fails_on_one_ulp(field):
    a = [_state(), _state(rho=1.2)]
    b = [State(**{k: getattr(st, k).clone() for k in ("u", "s", "gp", "p")})
         for st in a]
    reg._same_runs(a, b)
    t = getattr(b[1], field)
    t.view(-1)[5] = torch.nextafter(t.view(-1)[5], torch.tensor(
        np.inf, dtype=t.dtype))
    with pytest.raises(reg.CheckFailed, match=f"level 1 {field}"):
        reg._same_runs(a, b)
    with pytest.raises(reg.CheckFailed, match="levels"):
        reg._same_runs(a, a[:1])


def test_advect_3d_check_fails_in_both_packages_at_its_initial_data():
    """run_regression.py holds the 3-D advected bubble to [1, 2] within 2%
    of the jump (_check(v, sts, 2.0)), but prob_type 2 starts from the
    bubble's initial data, whose density rises to densfact = 10 in 3-D
    (initdata in both packages): the check fails from the first state on,
    in varden_tpu's harness as in the port's, at the same density."""
    from varden_tpu import problems as jproblems
    from varden_tpu.state import Sim as JSim
    from varden_tpu_torch import problems as tproblems
    from varden_tpu_torch.state import Sim
    jst = jproblems.initdata(JSim(_harness_fn("_load")("advect-3d", False)))
    tst = tproblems.initdata(Sim(reg._load("advect-3d", False), device="cpu"))
    jrho, trho = float(np.max(np.asarray(jst.s[0]))), float(tst.s[0].max())
    assert 9.0 < trho < 10.0 and abs(trho - jrho) <= 1e-14 * jrho
    with pytest.raises(AssertionError, match="level 0 rho overshoot"):
        _harness_fn("_check")(None, [jst], 2.0)
    with pytest.raises(reg.CheckFailed, match="level 0 rho overshoot"):
        reg._check(_driver((16, 16, 16)), [tst], 2.0)


def test_bubble_2d_four_levels_follows_varden_tpu():
    """The 2-D regression inputs with four levels (inputs/inputs_2d-regt: the
    bubble in a box with walls, regrid every 2 steps) at a 32^2 base for 4
    steps, across the step-3 regrid, the port held to varden_tpu step by step
    (float64, CPU; torch_inputs.hold_port_run): the initial hierarchy and data,
    the tree and data of the regrid, and the last step within 1e-9 of each
    field's size (varden_tpu pins this hierarchy's depth only in its own golden
    case, bubble-2d-ml4)."""
    tv, ts, boxes = hold_port_run(
        os.path.join(ROOT, "inputs", "inputs_2d-regt"), n_cellx=32,
        n_celly=32, max_step=4)
    assert len(ts) == 4 and tv.regrids >= 1 and len(boxes) == 4
    assert all(len(b) == 4 for _, b in boxes)


def test_rt_2d_three_levels_follows_varden_tpu():
    """The 2-D Rayleigh-Taylor regression inputs
    (inputs/inputs_RayleighTaylor_2d: periodic x, no-slip walls in y, three
    levels, regrid every 2 steps) at a 32^2 base for 3 steps, across the step-3
    regrid, the port held to varden_tpu step by step (float64, CPU;
    torch_inputs.hold_port_run): the initial hierarchy and data, the tree and
    data of the regrid, and the last step within 1e-9 of each field's size. Its
    patches span the periodic axis, so the coarse-fine fills and composite
    solves wrap across x."""
    tv, ts, boxes = hold_port_run(
        os.path.join(ROOT, "inputs", "inputs_RayleighTaylor_2d"),
        n_cellx=32, n_celly=32, max_step=3)
    assert len(ts) == 3 and tv.regrids >= 1 and len(boxes) == 3
    assert all(b[0][1] == (32, 32) for _, b in boxes)
    assert all(b[1][1][0] == 64 for _, b in boxes)  # spans periodic x


def test_advect_2d_two_levels_follows_varden_tpu():
    """The 2-D advection regression inputs (inputs/inputs_advect_2d: inlet at x
    lo with u_bc 1, outlet at x hi, slip walls in y, two levels, regrid every 2
    steps) at their shipped 64^2 base for 3 steps, across the step-3 regrid,
    the port held to varden_tpu step by step (float64, CPU;
    torch_inputs.hold_port_run): the initial hierarchy and data, the tree and
    data of the regrid, and the last step within 1e-9 of each field's size.
    Level 1 (64^2 at (32, 32), then 80^2 at (24, 24)) leaves the inlet face
    uncovered; a base whose level 1 covers the domain (32^2) is the inlet
    departure of ROADMAP.md section 3, which tests/test_torch_amr_solve.py
    holds with varden_tpu patched."""
    tv, ts, boxes = hold_port_run(
        os.path.join(ROOT, "inputs", "inputs_advect_2d"), max_step=3)
    assert len(ts) == 2 and tv.regrids >= 1 and len(boxes) == 3
    assert boxes[-1][1] == [((0, 0), (64, 64)), ((24, 24), (80, 80))]
