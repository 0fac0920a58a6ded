"""Multi-level runs decomposed over gloo ranks on the CPU (every patch of
every level cut into the ranks' blocks, parallel.mesh.make_patch_decomp)
against the one-rank run at the same ``mesh`` and against varden_tpu's
sharded run. The ranks run tests/torch_decomp_amr_cases.py through
varden_tpu_torch.parallel.launch: one spawn a world size, its cases
batched, each spawn bounded in time so that a deadlock fails the tests.

- Bit for bit, at 2 ranks (1x2) and 4 (2x2): parallel.halo's
  fetch and put against slices of the whole patch (cells padded and
  across a periodic seam, faces, nodes), the coarse-fine ghost fills
  (pad_ml, pad_phi, pad_corr), grow_mac_ml, edge_restrict_mac,
  restrict_and_sync, flux_sync and ml_estdt on two-level hierarchies,
  one with a replicated patch axis, and the nodal solve's interface
  values, prolongation, residual fold, slaving, masks and unmasked apply;
  and one fetch receives its box less the rank's own part, no more.
- Within 1e-12 of each field's size, with equal outer and V-cycle counts:
  the composite MAC and nodal solves in 2-D and 3-D (a child spanning a
  periodic axis, a child over part of an inlet face).
- Full runs against the one-rank run at the same mesh, with the same
  geom.key() at every step: inputs_3d-regt's settings at a 16^3 base on
  4 ranks across a regrid, the RT geometry (periodic x and y) at 16^3 on
  4 ranks across a regrid.
The 8-rank cases (2x4) are in tests/test_torch_decomp_amr8.py."""
import numpy as np
import pytest
import torch

import torch_decomp_amr_cases as cases
from torch_inputs import one_torch_thread  # noqa: F401
from varden_tpu_torch.parallel import launch

EXACT = ["copy", "ops:walls2d", "ops:per3d", "nodes:walls2d", "nodes:per3d",
         "nodes:inlet3d"]
SOLVES = ["solves:walls2d", "solves:per3d", "solves:inlet3d"]
BATCH = {2: EXACT + SOLVES,
         4: EXACT + SOLVES + ["run:regt@4", "run:rt3@4"]}
RUNS = [(4, "run:regt@4"), (4, "run:rt3@4")]
SPAWN_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def ranked():
    """{world size: {case: rank 0's result}}."""
    return {nr: launch.spawn(cases.run_batch, nr, names,
                             timeout=SPAWN_TIMEOUT)[0]
            for nr, names in BATCH.items()}


@pytest.fixture(scope="module")
def one_rank():
    """The runs on one rank at the same mesh (unsharded, with the
    regridder's mesh-quantised patches)."""
    torch.set_default_dtype(torch.float64)
    try:
        return {name: cases.run_case(1, name) for _nr, name in RUNS}
    finally:
        torch.set_default_dtype(torch.float32)


def _close(a, b, tol):
    for k in b:
        assert np.isfinite(a[k]).all(), k
        scale = max(1.0, float(np.abs(b[k]).max()))
        err = float(np.abs(a[k] - b[k]).max())
        assert err <= tol * scale, (k, err, scale)


def check_exact(ranked, nranks, names):
    """The bit-for-bit cases of ``names`` at ``nranks``."""
    for name in names:
        res = dict(ranked[nranks][name])
        if name == "copy":
            assert res["err"] == 0.0
            # no whole patch moves: one fetch receives its box less the
            # rank's own part
            assert res["received"] == res["want"] > 0
            continue
        rep = res.pop("rep", None)
        assert res and all(v == 0.0 for v in res.values()), (name, res)
        if name == "ops:walls2d":
            # the 18 cells of the third patch's x axis stay whole where
            # the mesh cuts x (2 ranks along it)
            assert rep == [False, False, nranks >= 4]


@pytest.mark.parametrize("nranks", [2, 4])
def test_fetch_put_and_ghost_fills_are_exact(ranked, nranks):
    check_exact(ranked, nranks, EXACT)


@pytest.mark.parametrize("nranks", [2, 4])
@pytest.mark.parametrize("name", SOLVES)
def test_composite_solves_match_one_rank(ranked, nranks, name):
    got = ranked[nranks][name]
    one, dec = got["one"], got["dec"]
    assert one["counts"] == dec["counts"]
    assert one["counts"][0] > 0 and one["counts"][1] > 0
    for kind in ("cc", "nd"):
        for a, b in zip(dec[kind], one[kind]):
            _close({kind: a}, {kind: b}, 1e-12)


@pytest.mark.parametrize("nranks,name", RUNS)
def test_run_matches_one_rank(ranked, one_rank, nranks, name):
    got, ref = ranked[nranks][name], one_rank[name]
    # the hierarchy, the V-cycles, the outer cycles and dt at every step
    assert [r[0] for r in got["rec"]] == [r[0] for r in ref["rec"]]
    assert [r[1:] for r in got["rec"]] == [r[1:] for r in ref["rec"]]
    assert len(got["rec"][-1][0]) >= 2  # refined
    for a, b in zip(got["states"], ref["states"]):
        _close(a, b, 1e-12)
