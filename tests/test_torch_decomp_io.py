"""Plotfiles, checkpoints and restarts of runs decomposed over 2 gloo ranks
on the CPU, single-level (a 2-D bubble at 16^2) and multi-level (at 32^2
with 2 levels, across a regrid), each with a checkpoint and a plotfile
every 2 steps to step 4:

- rank 0 alone writes: no other rank creates a file or a directory;
- every plotfile and checkpoint reads back within 1e-12 (of each field's
  size) of the one-rank run's at the same mesh, with the same boxes;
- a restart on 2 ranks from the step-2 checkpoint ends bit for bit equal
  to the uninterrupted 2-rank run;
- a checkpoint written by the one-rank mesh=2 run restarts on 2 ranks (to
  within 1e-12 of the uninterrupted run)."""
import os

import numpy as np
import pytest

import torch_decomp_amr_cases as cases
from torch_inputs import one_torch_thread  # noqa: F401
from varden_tpu_torch.io import boxlib
from varden_tpu_torch.parallel import launch

NAMES = ["sl", "ml"]
SPAWN_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: {"one", "full", "re", "from1": run result, "dir": base}}."""
    import torch
    base = tmp_path_factory.mktemp("decomp_io")
    out = {}
    torch.set_default_dtype(torch.float64)
    try:
        for nm in NAMES:
            out[nm] = {"one": cases.run_io(nm, 2, str(base / f"{nm}_one")),
                       "dir": base}
    finally:
        torch.set_default_dtype(torch.float32)
    jobs = []
    for nm in NAMES:
        d = str(base / nm)
        jobs += [(nm, d + "_full", -1, None), (nm, d + "_re", 2, d + "_full"),
                 (nm, d + "_from1", 2, d + "_one")]
    res = launch.spawn(cases.run_io_batch, 2, jobs,
                       timeout=SPAWN_TIMEOUT)[0]
    for i, nm in enumerate(NAMES):
        out[nm].update(zip(("full", "re", "from1"), res[3 * i:3 * i + 3]))
    return out


def _close(a, b, tol):
    assert a.shape == b.shape
    assert np.isfinite(a).all()
    scale = max(1.0, float(np.abs(b).max()))
    assert float(np.abs(a - b).max()) <= tol * scale


def _multifabs(path):
    """Every Level_* multifab under a plotfile or checkpoint directory."""
    for root, dirs, _files in sorted(os.walk(path)):
        for d in sorted(dirs):
            if d.startswith("Level_"):
                yield os.path.join(root, d)


@pytest.mark.parametrize("name", NAMES)
def test_only_rank_0_writes(runs, name):
    for tag in ("full", "re", "from1"):
        assert runs[name][tag]["others_wrote"] == []
    base = runs[name]["dir"]
    want = ["chk00000", "chk00002", "chk00004", "plt00000", "plt00002",
            "plt00004"]
    assert sorted(os.listdir(base / f"{name}_full")) == want
    assert sorted(os.listdir(base / f"{name}_one")) == want


@pytest.mark.parametrize("name", NAMES)
def test_files_read_back_as_the_one_rank_runs(runs, name):
    base = runs[name]["dir"]
    n = 0
    for d in sorted(os.listdir(base / f"{name}_one")):
        one, dec = str(base / f"{name}_one" / d), str(base / f"{name}_full"
                                                          / d)
        if d.startswith("plt"):
            names1, t1, lev1 = boxlib.read_plotfile(one)
            names2, t2, lev2 = boxlib.read_plotfile(dec)
            assert names1 == names2 and t1 == t2 and len(lev1) == len(lev2)
            for a, b in zip(lev2, lev1):
                _close(a, b, 1e-12)
        for m1, m2 in zip(_multifabs(one), _multifabs(dec)):
            assert os.path.relpath(m1, one) == os.path.relpath(m2, dec)
            boxes1, nodal1 = boxlib.read_multifab_boxes(m1)
            boxes2, nodal2 = boxlib.read_multifab_boxes(m2)
            assert nodal1 == nodal2
            assert [lo for _a, lo in boxes1] == [lo for _a, lo in boxes2]
            for (a, _l), (b, _m) in zip(boxes2, boxes1):
                _close(a, b, 1e-12)
                n += 1
    assert n >= 6


@pytest.mark.parametrize("name", NAMES)
def test_restart_on_two_ranks_is_bitwise(runs, name):
    full, re = runs[name]["full"], runs[name]["re"]
    assert re["istep"] == full["istep"] == 4 and re["time"] == full["time"]
    assert re["key"] == full["key"]
    for a, b in zip(full["states"], re["states"]):
        for k in a:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_one_rank_checkpoint_restarts_on_two_ranks(runs, name):
    full, fr1, one = runs[name]["full"], runs[name]["from1"], runs[name]["one"]
    assert fr1["istep"] == 4 and fr1["key"] == full["key"] == one["key"]
    for a, b in zip(fr1["states"], one["states"]):
        for k in a:
            _close(a[k], b[k], 1e-12)
