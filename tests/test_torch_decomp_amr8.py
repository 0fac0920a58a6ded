"""AMR under a mesh on 8 gloo ranks (2x4) on the CPU:
tests/test_sharding.py::test_driver_mesh_mode_two_level's configuration
against the one-rank run at mesh=8 (the same geom.key() and cycle counts
at every step, every field within 1e-12 of its size) and within 1e-9 of
varden_tpu's mesh=8 run over the 8 virtual CPU devices of
tests/conftest.py; and the coarse-fine operators on 2x4 blocks bit for
bit (the cases of
tests/torch_decomp_amr_cases.py, as tests/test_torch_decomp_amr.py runs
them at 2 and 4 ranks). The same configuration, and a one-step one
without pressure iterations, run on one rank at mesh=8 (warned, unsharded,
with the regridder's mesh-quantised patches) against varden_tpu's sharded
run, whose two-level run here is computed once for both comparisons."""
import warnings

import numpy as np
import pytest
import torch

import torch_decomp_amr_cases as cases
from test_torch_decomp_amr import _close, check_exact
from test_torch_mesh import clean_env  # noqa: F401
from torch_inputs import one_torch_thread  # noqa: F401
from varden_tpu_torch.parallel import launch

RUN = "run:two_level@8"
EXACT = ["ops:walls2d", "nodes:walls2d"]
SPAWN_TIMEOUT = 240.0
# tests/test_sharding.py's two mesh-mode AMR runs
MESH_RUNS = {
    # ::test_driver_mesh_mode_two_level: cases.TWO_LEVEL
    "two_level": dict(max_step=2, init_iter=1),
    # ::test_mesh_aware_clustering_partitions_fine_patch
    "mesh_aware_clustering": dict(max_step=1, init_iter=0)}


@pytest.fixture(scope="module")
def ranked():
    return {8: launch.spawn(cases.run_batch, 8, EXACT + [RUN],
                            timeout=SPAWN_TIMEOUT)[0]}


@pytest.fixture(scope="module")
def one_rank():
    torch.set_default_dtype(torch.float64)
    try:
        return cases.run_case(1, RUN)
    finally:
        torch.set_default_dtype(torch.float32)


@pytest.fixture(scope="module")
def varden_tpu_mesh8():
    """varden_tpu's sharded run (mesh=8 over tests/conftest.py's 8 virtual
    CPU devices) of the two-level configuration: (geom key, states)."""
    return _varden_tpu_mesh8_run(cases.TWO_LEVEL)


def _varden_tpu_mesh8_run(cfg):
    from varden_tpu.config import VardenConfig
    from varden_tpu.driver import Varden
    v = Varden(VardenConfig(**dict(cfg, mesh=8, verbose=0)))
    assert v.mesh is not None
    st = v.run()
    return v.geom.key(), [{k: np.array(getattr(s, k))
                           for k in ("u", "s", "gp", "p")} for s in st]


def test_operators_on_2x4_blocks_are_exact(ranked):
    check_exact(ranked, 8, EXACT)


def test_two_level_on_8_ranks_matches_one_rank(ranked, one_rank):
    got = ranked[8][RUN]
    assert [r[0] for r in got["rec"]] == [r[0] for r in one_rank["rec"]]
    assert [r[1:] for r in got["rec"]] == [r[1:] for r in one_rank["rec"]]
    assert len(got["rec"][-1][0]) >= 2  # refined
    for a, b in zip(got["states"], one_rank["states"]):
        _close(a, b, 1e-12)


def test_two_level_mesh8_matches_varden_tpu(ranked, varden_tpu_mesh8):
    key, ref = varden_tpu_mesh8
    got = ranked[8][RUN]
    assert got["rec"][-1][0] == key
    for a, b in zip(got["states"], ref):
        _close(a, b, 1e-9)


@pytest.mark.parametrize("over", list(MESH_RUNS.values()),
                         ids=list(MESH_RUNS))
def test_one_rank_mesh_amr_matches_varden_tpu(clean_env, request, over):
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.driver import Varden
    cfg = dict(cases.TWO_LEVEL, **over)
    if cfg == cases.TWO_LEVEL:
        key, js = request.getfixturevalue("varden_tpu_mesh8")
    else:
        key, js = _varden_tpu_mesh8_run(cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tv = Varden(VardenConfig(**dict(cfg, mesh=8, verbose=0)),
                    device="cpu")
        ts = tv.run()
    assert any("running unsharded" in str(w.message) for w in caught)
    assert tv.geom.key() == key
    assert len(ts) == len(js) >= 2
    for a, b in zip(ts, js):
        for k in ("u", "s", "gp", "p"):
            x, y = getattr(a, k).numpy(), b[k]
            assert np.abs(x - y).max() <= 1e-12 * max(1.0, np.abs(y).max())
