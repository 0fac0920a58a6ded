"""A 3-D multi-level restart of the port, shaped like the reference's
restart regression (inputs/inputs-restart-regt: the bubble, walls, regrid
every 2 steps, a checkpoint every 4 and a plotfile every 8 steps), cut to a
16^3 base with two levels, four steps, a checkpoint every 2 steps and a
plotfile at step 4 (float64, CPU). The run restarted from step 2, from a
copy of that checkpoint in its own directory, equals the uninterrupted run
bitwise in every field of every patch, keeps its hierarchy, and writes the
same step-4 plotfile and checkpoint files byte for byte (but job_info and
the write time that hints.npz records)."""
import os
import shutil
import zipfile

import torch

from torch_inputs import one_torch_thread  # noqa: F401
from varden_tpu_torch.config import load_config
from varden_tpu_torch.driver import Varden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


def test_restart_3d_two_levels_is_bitwise(tmp_path):
    path = os.path.join(ROOT, "inputs", "inputs-restart-regt")
    over = dict(n_cellx=16, n_celly=16, n_cellz=16, max_levs=2, max_step=4,
                chk_int=2, plot_int=4, dtype="float64", verbose=0)
    out = {}
    for tag, restart in (("full", -1), ("re", 2)):
        base = tmp_path / tag
        if restart >= 0:
            shutil.copytree(tmp_path / "full" / "chk00002",
                            base / "chk00002")
        v = Varden(load_config(path, restart=restart,
                               plot_base_name=str(base / "plt"),
                               check_base_name=str(base / "chk"), **over),
                   device="cpu")
        out[tag] = (v, v.run())
    (vf, sf), (vr, sr) = out["full"], out["re"]
    assert vr.istep == vf.istep == 4 and vr.time == vf.time
    assert vf.regrids > 0 and len(sf) == len(sr) >= 2
    assert vf.geom.key() == vr.geom.key()
    for a, b in zip(sf, sr):
        for k in ("u", "s", "gp", "p"):
            assert torch.isfinite(getattr(a, k)).all(), k
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    for d in ("plt00004", "chk00004"):
        names = _files(str(tmp_path / "full" / d))
        assert names == _files(str(tmp_path / "re" / d))
        for f in names:
            if f in ("job_info", "hints.npz"):
                continue
            with open(tmp_path / "full" / d / f, "rb") as fa, \
                    open(tmp_path / "re" / d / f, "rb") as fb:
                assert fa.read() == fb.read(), (d, f)
    assert _npz_members(tmp_path / "full" / "chk00004" / "hints.npz") \
        == _npz_members(tmp_path / "re" / "chk00004" / "hints.npz")
