"""The port's plotfiles, checkpoints and restarts (varden_tpu_torch.io and
the driver) against varden_tpu's, on the CPU.

From one numpy state (single-level 2-D and 3-D, and two-level 2-D
hierarchies: sibling patches between walls, and a patch spanning a
periodic axis) both packages write a checkpoint and a plotfile:
- the checkpoint directories are equal byte for byte, apart from job_info
  (each package names its own devices) and hints.npz, whose zip entries
  carry their write time: its members are the same, in the same order,
  with the same bytes;
- the plotfile directories are equal byte for byte apart from job_info and
  the magvel and vort components, which one package computes with jnp and
  the other with torch: those hold to 1e-12 relative in the FAB data and
  in Cell_H's min/max;
- each package reads the other's checkpoint back to the arrays written.
Then restarts: a 2-D 16^2 run, single-level and with 2 levels across a
regrid, checkpointed at step 2 and restarted to step 4 equals the
uninterrupted run bitwise; and the CLI writes the RT inputs' plotfiles and
checkpoints. Last, the restart regression workload at three levels,
bitwise and held to varden_tpu at the step it resumes with (its section
below). It sits in this file, beside its many cheap tests, because
pytest-xdist's --dist loadfile hands the files out by their number of
tests, most first: a file of one heavy test would start last and make the
run's tail."""
import os
import shutil
import subprocess
import sys
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import ref_jit, regularise_reference, state_arrays
from varden_tpu.amr import advance_ml as jadv
from varden_tpu.amr import fill as jfill
from varden_tpu.amr import hierarchy as jh
from varden_tpu.config import VardenConfig as JCfg
from varden_tpu.config import load_config as jload
from varden_tpu.io import output as jout
from varden_tpu.solvers import nodal as jnodal
from varden_tpu.state import Sim as JSim
from varden_tpu.state import State as JState
from varden_tpu_torch import regression as reg
from varden_tpu_torch.amr import advance_ml as tadv
from varden_tpu_torch.amr.fill import hierarchy_from_numpy
from varden_tpu_torch.config import VardenConfig as TCfg
from varden_tpu_torch.driver import Varden as TVarden
from varden_tpu_torch.io import boxlib as tbox
from varden_tpu_torch.io import output as tout
from varden_tpu_torch.state import Sim as TSim
from varden_tpu_torch.state import state_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIME, DT = 0.123456789012345, 1.5e-3
# (config overrides, patch tree (lo, n), parent, depth)
CASES = {
    "2d": (dict(dim_in=2, n_cellx=16, n_celly=12, bcy_lo=-1, bcy_hi=-1),
           [((0, 0), (16, 12))], [-1], [0]),
    "2d-coarsen": (dict(dim_in=2, n_cellx=16, n_celly=12,
                        coarsen_plot_data=1),
                   [((0, 0), (16, 12))], [-1], [0]),
    "3d": (dict(dim_in=3, n_cellx=8, n_celly=6, n_cellz=10, bcx_lo=-1,
                bcx_hi=-1, bcy_lo=-1, bcy_hi=-1),
           [((0, 0, 0), (8, 6, 10))], [-1], [0]),
    "2d-siblings": (dict(dim_in=2, max_levs=2),
                    [((0, 0), (32, 32)), ((8, 8), (16, 16)),
                     ((40, 32), (16, 24))], [-1, 0, 0], [0, 1, 1]),
    "2d-periodic-span": (dict(dim_in=2, max_levs=2, bcx_lo=-1, bcx_hi=-1),
                         [((0, 0), (32, 32)), ((0, 16), (64, 24))],
                         [-1, 0], [0, 1]),
}
PLOT_SKIP = ("magvel", "vort")


def _sims(over):
    kw = dict(prob_type=1, n_cellx=32, n_celly=32, n_cellz=32, grav=-9.8,
              dtype="float64", bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15,
              bcz_lo=15, bcz_hi=15)
    kw.update(over)
    return JSim(JCfg(**kw)), TSim(TCfg(**kw), device="cpu")


def _data(js, specs):
    """Per patch: the state (u, s, gp, p) and the warm starts, from a
    seed; a patch spanning a periodic axis carries n nodes there."""
    rng = np.random.RandomState(4)
    dm = js.dm
    out = []
    for i, (lo, n) in enumerate(specs):
        # patch 0 is the base level, the others one level finer
        dn = [js.n_cell[t] * (1 if i == 0 else 2) for t in range(dm)]
        pm = [js.pmask[t] and lo[t] == 0 and n[t] == dn[t]
              for t in range(dm)]
        ns = jnodal.node_shape(tuple(n), pm)
        a = {"u": rng.rand(dm, *n) - 0.5, "s": 1.0 + rng.rand(2, *n),
             "gp": rng.rand(dm, *n), "p": rng.rand(*ns) - 0.5}
        h = {"phi_mac": rng.rand(*n), "phi_mac_prev": rng.rand(*n),
             "phi_hg": rng.rand(*ns), "phi_hg_prev": rng.rand(*ns)}
        out.append((a, h))
    return out


def _write_both(case, root):
    """Checkpoint and plotfile of one state by both packages; returns the
    two Sims, the data and the directories."""
    over, specs, parent, depth = CASES[case]
    js, ts = _sims(over)
    data = _data(js, specs)
    jdir, tdir = str(root / "jax"), str(root / "torch")
    if len(specs) == 1:
        a, h = data[0]
        jst = JState(**{k: jnp.asarray(v) for k, v in a.items()})
        tst, th = state_from_numpy(ts, a, h)
        jh_ = {k: jnp.asarray(v) for k, v in h.items()}
        names = [jout.write_checkpoint(js, jst, 7, TIME, DT,
                                       base=jdir + "/chk", hints=jh_),
                 jout.write_plotfile(js, jst, 7, TIME, DT,
                                     base=jdir + "/plt"),
                 tout.write_checkpoint(ts, tst, 7, TIME, DT,
                                       base=tdir + "/chk", hints=th),
                 tout.write_plotfile(ts, tst, 7, TIME, DT,
                                     base=tdir + "/plt")]
    else:
        jg = jfill.MLGeom(js, [jh.LevelSpec(*s) for s in specs], parent,
                          depth)
        jst = [JState(**{k: jnp.asarray(v) for k, v in a.items()})
               for a, _ in data]
        tg, tst = hierarchy_from_numpy(ts, specs, parent, depth,
                                       [a for a, _ in data])
        keys = ("phi_mac", "phi_hg", "phi_mac_prev", "phi_hg_prev")
        jh_ = {k: [jnp.asarray(h[k]) for _, h in data] for k in keys}
        th = {k: [torch.as_tensor(h[k]) for _, h in data] for k in keys}
        names = [jout.write_checkpoint_ml(jg, jst, 7, TIME, DT,
                                          base=jdir + "/chk", hints=jh_),
                 jout.write_plotfile_ml(jg, jst, 7, TIME,
                                        base=jdir + "/plt"),
                 tout.write_checkpoint_ml(tg, tst, 7, TIME, DT,
                                          base=tdir + "/chk", hints=th),
                 tout.write_plotfile_ml(tg, tst, 7, TIME,
                                        base=tdir + "/plt")]
    return js, ts, data, names


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


@pytest.mark.parametrize("case", sorted(CASES))
def test_checkpoint_matches_varden_tpu(tmp_path, case):
    _js, _ts, _data_, (jchk, _jplt, tchk, _tplt) = _write_both(case, tmp_path)
    files = _files(jchk)
    assert files == _files(tchk) and "hints.npz" in files
    for f in files:
        if f == "job_info":
            continue
        a, b = os.path.join(jchk, f), os.path.join(tchk, f)
        if f == "hints.npz":
            assert _npz_members(a) == _npz_members(b)
            continue
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), f


def _plot_components(plt_dir):
    with open(os.path.join(plt_dir, "Header")) as f:
        lines = f.read().splitlines()
    return lines[2:2 + int(lines[1])]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plotfile_matches_varden_tpu(tmp_path, case):
    _js, _ts, _data_, (_jchk, jplt, _tchk, tplt) = _write_both(case,
                                                               tmp_path)
    files = _files(jplt)
    assert files == _files(tplt)
    names = _plot_components(jplt)
    skip = [names.index(nm) for nm in PLOT_SKIP]
    for f in files:
        a, b = os.path.join(jplt, f), os.path.join(tplt, f)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            ba, bb = fa.read(), fb.read()
        base = os.path.basename(f)
        if base.startswith("Cell_D"):
            ha, hb = ba.split(b"\n", 1)[0], bb.split(b"\n", 1)[0]
            assert ha == hb, f
            da = np.frombuffer(ba[len(ha) + 1:], np.float64)
            db = np.frombuffer(bb[len(hb) + 1:], np.float64)
            da, db = (x.reshape(len(names), -1) for x in (da, db))
            for c in range(len(names)):
                if c in skip:
                    scale = max(1.0, float(np.abs(da[c]).max()))
                    assert float(np.abs(da[c] - db[c]).max()) <= \
                        1e-12 * scale, (f, names[c])
                else:
                    assert np.array_equal(da[c], db[c]), (f, names[c])
        elif base == "Cell_H":
            la, lb = ba.decode().splitlines(), bb.decode().splitlines()
            assert len(la) == len(lb)
            for x, y in zip(la, lb):
                if x == y:
                    continue
                # a min or max row: the comps but magvel/vort equal
                xs, ys = x.rstrip(",").split(","), y.rstrip(",").split(",")
                assert len(xs) == len(names) == len(ys), f
                for c, (u, v) in enumerate(zip(xs, ys)):
                    if c in skip:
                        assert abs(float(u) - float(v)) <= 1e-12 * max(
                            1.0, abs(float(u))), (f, names[c])
                    else:
                        assert u == v, (f, names[c])
        else:
            assert ba == bb, f


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_package_reads_the_others_checkpoint(tmp_path, case):
    js, ts, data, (jchk, _jplt, tchk, _tplt) = _write_both(case, tmp_path)
    keys = ("u", "s", "gp", "p")
    if len(data) == 1:
        for src in (jchk, tchk):
            tst, theader, th = tout.read_checkpoint(ts, src)
            jst, jheader, jh_ = jout.read_checkpoint(js, src)
            assert theader == jheader
            assert theader["time"] == TIME and theader["dt"] == DT
            assert theader["istep"] == 7
            for k in keys:
                # C order: the card's kernels refuse other layouts
                assert getattr(tst, k).is_contiguous()
                assert np.array_equal(getattr(tst, k).numpy(), data[0][0][k])
                assert np.array_equal(np.asarray(getattr(jst, k)),
                                      data[0][0][k])
            for k, v in data[0][1].items():
                assert np.array_equal(th[k].numpy(), v)
                assert np.array_equal(np.asarray(jh_[k]), v)
        return
    _over, specs, parent, depth = CASES[case]
    for src in (jchk, tchk):
        tg, tst, theader, th = tout.read_checkpoint_ml(ts, src)
        jg, jst, jheader, jh_ = jout.read_checkpoint_ml(js, src)
        assert theader == jheader
        assert [(s.lo, s.n) for s in tg.specs] == \
            [(tuple(lo), tuple(n)) for lo, n in specs]
        assert tg.parent == jg.parent == parent and tg.depth == depth
        for i, (a, h) in enumerate(data):
            for k in keys:
                assert getattr(tst[i], k).is_contiguous()
                assert np.array_equal(getattr(tst[i], k).numpy(), a[k])
                assert np.array_equal(np.asarray(getattr(jst[i], k)), a[k])
            for k, v in h.items():
                assert th[k][i].is_contiguous()
                assert np.array_equal(th[k][i].numpy(), v)
                assert np.array_equal(np.asarray(jh_[k][i]), v)


@pytest.mark.parametrize("levels", [1, 2])
def test_restart_is_bitwise(tmp_path, levels):
    """2-D bubble 16^2 (2 levels: regrid every 2 steps), a checkpoint every
    2 steps and a plotfile at step 4; a restart from step 2 (a copy of the
    checkpoint in its own directory) to step 4 equals the uninterrupted run
    in every field of every patch, and writes the same step-4 files."""
    kw = dict(dim_in=2, prob_type=1, n_cellx=16, n_celly=16, grav=-9.8,
              dtype="float64", visc_coef=1e-3, cflfac=0.9, init_shrink=0.1,
              init_iter=1, max_levs=levels, regrid_int=2, max_step=4,
              chk_int=2, plot_int=4, bcx_lo=15, bcx_hi=15, bcy_lo=15,
              bcy_hi=15, verbose=0)
    out = {}
    for tag, restart in (("full", -1), ("re", 2)):
        base = tmp_path / tag
        if restart >= 0:
            shutil.copytree(tmp_path / "full" / "chk00002",
                            base / "chk00002")
        v = TVarden(TCfg(**dict(kw, restart=restart,
                                plot_base_name=str(base / "plt"),
                                check_base_name=str(base / "chk"))),
                    device="cpu")
        st = v.run()
        out[tag] = (v, st if levels > 1 else [st])
    (vf, sf), (vr, sr) = out["full"], out["re"]
    assert vr.istep == vf.istep == 4 and vr.time == vf.time
    assert len(sf) == len(sr)
    if levels > 1:
        assert vf.geom.key() == vr.geom.key() and vf.regrids > 0
    for a, b in zip(sf, sr):
        for k in ("u", "s", "gp", "p"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    for d in ("plt00004", "chk00004"):
        for f in _files(str(tmp_path / "full" / d)):
            if f in ("job_info", "hints.npz"):
                continue
            with open(tmp_path / "full" / d / f, "rb") as fa, \
                    open(tmp_path / "re" / d / f, "rb") as fb:
                assert fa.read() == fb.read(), (d, f)
        assert _npz_members(tmp_path / "full" / "chk00004" / "hints.npz") \
            == _npz_members(tmp_path / "re" / "chk00004" / "hints.npz")


def test_cli_writes_the_rt_inputs_output(tmp_path):
    args = [sys.executable, "-m", "varden_tpu_torch",
            os.path.join(ROOT, "inputs", "inputs_RayleighTaylor_3d"),
            "--n_cellx", "16", "--n_celly", "16", "--n_cellz", "16",
            "--max_step", "2", "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("PROBIN", None)
    res = subprocess.run(args, cwd=tmp_path, capture_output=True, text=True,
                         timeout=600, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "STEP =    2" in res.stdout
    # plot_int 10, chk_int 100: step 0 and the final step off the cadence
    assert sorted(os.listdir(tmp_path)) == ["chk00000", "chk00002",
                                            "plt00000", "plt00002"]
    names, time, levels = tbox.read_plotfile(str(tmp_path / "plt00002"))
    assert names[:5] == ["x_vel", "y_vel", "z_vel", "density", "tracer"]
    assert len(levels) == 2 and time > 0.0
    assert all(np.isfinite(a).all() for a in levels)


# The restart regression workload (inputs/inputs-restart-regt: the 3-D bubble
# in a box with walls, regrid every 2 steps, a checkpoint every 4) at an 8^3
# base with its three levels, float64, CPU: the port's run of 8 steps restarted
# from chk00004 equals its continuous run bitwise on every patch
# (varden_tpu_torch.regression.bubble_restart), and the step the restart
# resumes with follows varden_tpu's.
#
# At this base (as at 16^3) level 1 covers the domain with walls on every side,
# so its composite nodal correction problem is singular: the three-level
# departure of ROADMAP.md section 3, held with the method of
# tests/test_torch_amr_hierarchy.py's three-level tests. varden_tpu's
# ml_advance (under jax.jit) takes the port's step from the port's checkpointed
# state and warm starts (chk00004, hierarchy 8^3, 16^3 and 32^3 over the
# domain), with the port's regularisation patched in (a fine level whose nodal
# mask fixes no node gets its multigrid hierarchy built with mask None), and
# agrees in every field of every patch within 1e-9 of its size. varden_tpu's
# whole run of 8 steps is not taken: one compile of its three-level step takes
# 2-4 minutes on one core, and at a 16^3 base a step 40-90 s
# (tests/test_torch_amr_hierarchy.py holds step 1 of the 16^3 run the same
# way).
RESTART_PATH = os.path.join(ROOT, "inputs", "inputs-restart-regt")
RESTART_OVER = dict(n_cellx=8, n_celly=8, n_cellz=8, max_levs=3)


def _spy_resumed_step(monkeypatch):
    """Record the inputs and output of the first ml_advance after a
    restart_ml (the step the restarted run resumes with)."""
    seen, resumed = [], []
    restart_ml, advance = TVarden.restart_ml, tadv.ml_advance

    def spied_restart(self):
        resumed.append(True)
        return restart_ml(self)

    def spied_advance(geom, states, dt, proj_type, hints=None):
        if not resumed or seen:
            return advance(geom, states, dt, proj_type, hints=hints)
        entry = dict(geom=geom, states=state_arrays(states), dt=float(dt),
                     proj_type=proj_type,
                     hints={k: [t.numpy().copy() for t in v]
                            for k, v in (hints or {}).items()})
        out = advance(geom, states, dt, proj_type, hints=hints)
        entry["out"] = state_arrays(out[0])
        seen.append(entry)
        return out

    monkeypatch.setattr(TVarden, "restart_ml", spied_restart)
    monkeypatch.setattr(tadv, "ml_advance", spied_advance)
    return seen


def test_restart_at_three_levels_is_bitwise_and_resumes_as_varden_tpu(
        monkeypatch):
    seen = _spy_resumed_step(monkeypatch)
    out = reg.bubble_restart(device="cpu", verbose=0, **RESTART_OVER)
    assert out["bitwise"] and out["steps"] == 8 and out["steps_run"] == 12
    assert len(out["levels"]) == 3 and len(seen) == 1
    step = seen[0]
    geom = step["geom"]
    assert [tuple(s.n) for s in geom.specs] == \
        [(8, 8, 8), (16, 16, 16), (32, 32, 32)]
    assert set(step["hints"]) >= {"phi_mac", "phi_hg"}

    free = regularise_reference(monkeypatch)
    jg = jfill.MLGeom(JSim(jload(RESTART_PATH, dtype="float64",
                                 **RESTART_OVER)),
                      [jh.LevelSpec(tuple(s.lo), tuple(s.n))
                       for s in geom.specs], list(geom.parent),
                      list(geom.depth))
    jst = [JState(**{k: jnp.asarray(v) for k, v in a.items()})
           for a in step["states"]]
    hints = {k: [jnp.asarray(v) for v in vs]
             for k, vs in step["hints"].items()}
    jout, jdiag = ref_jit(lambda st, h: jadv.ml_advance(
        jg, st, step["dt"], step["proj_type"], hints=h))(jst, hints)
    assert free, "no fine level of varden_tpu's step was regularised"
    assert float(jdiag["hg_ratio"]) <= 1.0
    for a, b in zip(step["out"], state_arrays(jout)):
        for k in a:
            scale = max(1.0, float(np.abs(b[k]).max()))
            assert float(np.abs(a[k] - b[k]).max()) <= 1e-9 * scale, k
