"""Single-level runs decomposed over gloo ranks on the CPU against the
one-rank run and against varden_tpu unsharded (the tests/test_sharding.py
cases). The ranks run tests/torch_decomp_cases.py through
varden_tpu_torch.parallel.launch: one spawn a world size, its cases
batched, each spawn bounded in time so that a deadlock fails the tests.

- Bit for bit, at 2 ranks (1x2) and 4 ranks (2x2): the halo exchange
  against slices of the whole level grown by periodic wrap, the ghost fill
  of every recipe code (and grow_mac) against the whole level's fill
  sliced, and estdt.
- Within 1e-12 of each field's size, with the same V-cycle counts: the
  solvers (mg.solve with face beta, kernel 7's frozen-ring levels and a
  Helmholtz batch; nodal.solve with walls, periodic axes and an outlet)
  and full steps (the 2-D bubble at 32^2, the 3-D periodic box at 16^3,
  the 2-D inlet/outlet driver run; a viscous walled 3-D bubble at 16^3 on
  4 ranks, the 2-D bubble on 8 ranks, 2x4).
- Within 1e-9: the one-rank and decomposed runs against varden_tpu
  unsharded (the periodic box with varden_tpu's accelerator route to the
  padded sweep, as the port's rule takes it)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_decomp_cases as cases
from torch_inputs import force_padded_route, one_torch_thread  # noqa: F401
from torch_inputs import ref_jit
from varden_tpu_torch.parallel import launch

SOLVES = ["mg:face2d", "mg:const3d", "mg:padded3d", "nodal:walls2d",
          "nodal:periodic3d", "nodal:outlet3d"]
RUNS = ["steps:bubble2d", "steps:periodic3d", "inlet"]
EXACT = ["halo", "fill", "estdt"]
BATCH = {2: EXACT + SOLVES + RUNS,
         4: EXACT + SOLVES + RUNS + ["steps:visc3d"],
         8: ["steps:bubble2d"]}
SPAWN_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def ranked():
    """{world size: {case: rank 0's result}}."""
    return {nr: launch.spawn(cases.run_batch, nr, names,
                             timeout=SPAWN_TIMEOUT)[0]
            for nr, names in BATCH.items()}


@pytest.fixture(scope="module")
def one_rank():
    torch.set_default_dtype(torch.float64)
    try:
        return {name: cases.run_case(1, name)
                for name in ["estdt"] + SOLVES + RUNS + ["steps:visc3d"]}
    finally:
        torch.set_default_dtype(torch.float32)


def _close(a, b, tol):
    for k in b:
        assert np.isfinite(a[k]).all(), k
        scale = max(1.0, float(np.abs(b[k]).max()))
        err = float(np.abs(a[k] - b[k]).max())
        assert err <= tol * scale, (k, err, scale)


@pytest.mark.parametrize("nranks", [2, 4])
@pytest.mark.parametrize("name", ["halo", "fill"])
def test_exchange_and_ghost_fill_are_exact(ranked, nranks, name):
    assert ranked[nranks][name] == 0.0


@pytest.mark.parametrize("nranks", [2, 4])
def test_estdt_is_exact(ranked, one_rank, nranks):
    assert ranked[nranks]["estdt"] == one_rank["estdt"]


@pytest.mark.parametrize("nranks", [2, 4])
@pytest.mark.parametrize("name", SOLVES)
def test_solve_matches_one_rank(ranked, one_rank, nranks, name):
    phi, cycles, _rn = ranked[nranks][name]
    ref, ref_cycles, _ = one_rank[name]
    assert cycles == ref_cycles > 0
    _close({"phi": phi}, {"phi": ref}, 1e-12)


@pytest.mark.parametrize("nranks,name", [
    (2, "steps:bubble2d"), (2, "steps:periodic3d"), (2, "inlet"),
    (4, "steps:bubble2d"), (4, "steps:periodic3d"), (4, "inlet"),
    (4, "steps:visc3d"), (8, "steps:bubble2d")])
def test_run_matches_one_rank(ranked, one_rank, nranks, name):
    got, ref = ranked[nranks][name], one_rank[name]
    assert got[1] == ref[1] and got[1]["mg"] > 0 and got[1]["nodal"] > 0
    if name == "inlet":
        assert got[2] == ref[2]
    _close(got[0], ref[0], 1e-12)


def _jax_steps(name):
    from varden_tpu import advance, problems, projection
    from varden_tpu.config import VardenConfig
    from varden_tpu.state import Sim
    sim = Sim(VardenConfig(**cases.STEP_CFGS[name]))
    state = problems.initdata(sim)
    step = ref_jit(lambda s, dt: advance.advance_timestep(
        sim, s, dt, projection.REGULAR_TIMESTEP)[0])
    dt = jnp.asarray(cases.STEP_DT, sim.dtype)
    for _ in range(cases.STEPS):
        state = step(state, dt)
    return {k: np.array(getattr(state, k)) for k in ("u", "s", "gp", "p")}


@pytest.fixture(scope="module")
def reference():
    """varden_tpu unsharded on the CPU in float64."""
    from varden_tpu.config import VardenConfig
    from varden_tpu.driver import Varden
    out = {"steps:bubble2d": _jax_steps("bubble2d"),
           "steps:visc3d": _jax_steps("visc3d")}
    with pytest.MonkeyPatch.context() as mp:
        force_padded_route(mp)
        out["steps:periodic3d"] = _jax_steps("periodic3d")
    st = Varden(VardenConfig(**cases.INLET_CFG, verbose=0)).run()
    out["inlet"] = {k: np.array(getattr(st, k))
                    for k in ("u", "s", "gp", "p")}
    return out


@pytest.mark.parametrize("name", RUNS + ["steps:visc3d"])
def test_runs_match_varden_tpu(ranked, one_rank, reference, name):
    _close(one_rank[name][0], reference[name], 1e-9)
    for nranks, names in BATCH.items():
        if name in names:
            _close(ranked[nranks][name][0], reference[name], 1e-9)
