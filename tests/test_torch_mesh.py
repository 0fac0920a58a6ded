"""Mesh bookkeeping of the port (varden_tpu_torch.parallel.mesh) against
varden_tpu.parallel.mesh: joining a process group from the environment,
rank-0 I/O gating, the mesh factoring, the rank blocks and neighbours.
The mesh runs on one rank (which warn and run unsharded with the
regridder's mesh-quantised patches) against varden_tpu at mesh=8 are in
tests/test_torch_decomp_amr8.py, beside the 8-rank run of the same
configuration, so that varden_tpu's sharded run is compiled once."""
import pytest
import torch.distributed as dist

from torch_inputs import one_torch_thread  # noqa: F401
from varden_tpu_torch.parallel import mesh as pmesh

ENV = ("VARDEN_COORDINATOR", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
       "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


# the four cases of tests/test_multihost.py

def test_no_env_is_noop(clean_env):
    assert pmesh.maybe_init_distributed() is False


@pytest.mark.parametrize("env,kw", [
    ({"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_NUM_PROCESSES": "4",
      "JAX_PROCESS_ID": "2"},
     {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
      "world_size": 4, "rank": 2}),
    ({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234", "WORLD_SIZE": "4",
      "RANK": "3"},
     {"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
      "world_size": 4, "rank": 3}),
])
def test_coordinator_env_initializes(clean_env, env, kw):
    calls = []
    for k, v in env.items():
        clean_env.setenv(k, v)
    clean_env.setattr(dist, "init_process_group",
                      lambda **k: calls.append(k))
    assert pmesh.maybe_init_distributed(device="cpu") is True
    assert calls == [kw]


def test_already_initialized_short_circuits(clean_env):
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    clean_env.setattr(dist, "is_initialized", lambda: True)
    called = []
    clean_env.setattr(dist, "init_process_group",
                      lambda **k: called.append(k))
    assert pmesh.maybe_init_distributed() is True
    assert called == []


def test_io_proc_gating(monkeypatch):
    assert pmesh.is_io_proc()  # single process
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    assert not pmesh.is_io_proc()


# ---------------------------------------------------------------------------

def test_mesh_shape_matches_varden_tpu():
    from varden_tpu.parallel.mesh import mesh_shape
    for n in range(1, 33):
        assert pmesh.mesh_shape(n) == mesh_shape(n)


def test_decomp_blocks_and_neighbours():
    """2x2 ranks on a 16x8x4 level periodic in x: blocks, offsets, the
    wrapped neighbours across the periodic seam, none across the walls."""
    n, pm = (16, 8, 4), (True, False, False)
    decs = [pmesh.make_decomp(n, pm, 4, r) for r in range(4)]
    assert [d.coords[:2] for d in decs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(d.n == (8, 4, 4) for d in decs)
    assert [d.lo for d in decs] == [(0, 0, 0), (0, 4, 0), (8, 0, 0),
                                    (8, 4, 0)]
    d0 = decs[0]
    assert (d0.nbr(0, 0), d0.nbr(0, 1)) == (2, 2)
    assert d0.seam(0, 0) and not d0.seam(0, 1)
    assert (d0.nbr(1, 0), d0.nbr(1, 1)) == (None, 1)
    assert d0.nbr(2, 0) is None and d0.local_pmask == (False, False, False)
    assert d0.coarsen((2, 2, 2)).n == (4, 2, 2)
    assert not d0.coarsen((2, 2, 2)).keeps_blocks()
    with pytest.raises(ValueError):
        pmesh.make_decomp((12, 6), (False, False), 8, 0)


def test_one_rank_mesh_run_warns_and_refuses_mismatch(clean_env):
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.driver import Varden
    cfg = dict(dim_in=2, prob_type=1, n_cellx=16, n_celly=16,
               dtype="float64")
    with pytest.warns(UserWarning, match="running unsharded"):
        v = Varden(VardenConfig(**cfg, mesh=4), device="cpu")
    assert v.sim.dec is None
    clean_env.setattr(dist, "is_initialized", lambda: True)
    clean_env.setattr(dist, "get_world_size", lambda: 2)
    clean_env.setattr(dist, "get_rank", lambda: 0)
    with pytest.raises(ValueError, match="2 ranks"):
        Varden(VardenConfig(**cfg, mesh=4), device="cpu")
    # AMR, plotfiles, checkpoints and restarts run under a mesh now: an AMR
    # run decomposes its patches (fill.MLGeom) over the group, a
    # single-level one with output its level
    v = Varden(VardenConfig(**cfg, mesh=2, max_levs=2), device="cpu")
    assert v.sim.dec is None and v.sim.ml_ranks == 2
    v = Varden(VardenConfig(**cfg, mesh=2, plot_int=5, chk_int=5),
               device="cpu")
    assert v.sim.dec is not None and v.sim.dec.n == (16, 8)
    clean_env.setattr(dist, "get_world_size", lambda: 8)
    with pytest.raises(ValueError, match="even block"):
        Varden(VardenConfig(**dict(cfg, n_celly=12), mesh=8), device="cpu")


def test_nest_into_snaps_extents_as_varden_tpu():
    """The regridder's mesh quanta: the same clipped and snapped patch as
    varden_tpu's _nest_into for boxes whose extents do not divide the
    mesh axes, with and without a mesh."""
    from varden_tpu.amr import regrid as jregrid
    from varden_tpu.amr.hierarchy import LevelSpec as JSpec
    from varden_tpu.config import VardenConfig as JCfg
    from varden_tpu.state import Sim as JSim
    from varden_tpu_torch.amr import regrid
    from varden_tpu_torch.amr.hierarchy import LevelSpec
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.state import Sim
    boxes = [((10, 6), (30, 20)), ((2, 2), (14, 26)), ((40, 8), (62, 18)),
             ((0, 0), (22, 10))]
    snapped = 0
    for mesh in (0, 8, 6):
        kw = dict(dim_in=2, n_cellx=32, n_celly=32, mesh=mesh)
        jsim, tsim = JSim(JCfg(**kw)), Sim(VardenConfig(**kw), device="cpu")
        for lo, hi in boxes:
            j = jregrid._nest_into(jsim, lo, hi, JSpec((0, 0), (32, 32)), 0)
            t = regrid._nest_into(tsim, lo, hi, LevelSpec((0, 0), (32, 32)),
                                  0)
            assert (t.lo, t.n) == (j.lo, j.n)
            if mesh == 8:
                snapped += t.n != regrid._nest_into(
                    Sim(VardenConfig(**dict(kw, mesh=0)), device="cpu"),
                    lo, hi, LevelSpec((0, 0), (32, 32)), 0).n
    assert snapped > 0
