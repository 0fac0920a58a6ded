"""Plotfile and checkpoint output (counterpart of varden_tpu.io.output).

The reference writes BoxLib-format plotfiles and checkpoint directories
(src/checkpoint.f90:14-145, varden.f90:492-620); both go through the
numpy FAB writer of io/boxlib.py. Each write gathers every tensor it needs
on the device and copies them to the host in one transfer. A checkpoint
also carries the projections' warm starts in hints.npz (a file the
reference does not have), so that a restarted run reproduces the
uninterrupted one bitwise.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..amr.hierarchy import LevelSpec, restrict_cells
from ..ops import basic
from ..parallel import halo
from ..parallel import mesh as pmesh
from ..solvers.nodal import node_extra
from ..state import Sim, State


def _written():
    """Every rank waits until rank 0 has written (a decomposed run), so
    that no rank reads a file before it is complete."""
    if torch.distributed.is_initialized():
        torch.distributed.barrier()


def _whole(sim: Sim, t, nodal=False):
    """The whole level from the rank's block of a decomposed single-level
    run (exact); ``t`` itself otherwise."""
    dec = sim.dec
    if dec is None:
        return t
    if not nodal:
        return halo.gather(t, dec)
    return halo.gather(t, dec, node_extra(dec.local_pmask),
                       node_extra(dec.pmask))


def _block(sim: Sim, t, nodal=False):
    return t if sim.dec is None else sim.dec.block(t, nodal).contiguous()


def _to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The tensors as numpy arrays, through one device-to-host copy."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def plot_field_names(sim: Sim):
    """reference varden.f90:76-87"""
    dm, nscal = sim.dm, sim.nscal
    names = ["x_vel", "y_vel"] + (["z_vel"] if dm > 2 else [])
    names += ["density"] + (["tracer"] if nscal > 1 else [])
    names += ["magvel", "vort"]
    names += ["gpx", "gpy"] + (["gpz"] if dm > 2 else [])
    return names


def _plot_stack(state: State, u_pad, dx, ng, n, phys_bc) -> torch.Tensor:
    """(nfields, *n) plot variables on the device, in the reference's
    plotfile component order."""
    vort = basic.vorticity(u_pad, dx, ng, n, phys_bc=phys_bc)
    return torch.cat([state.u, state.s, basic.magvel(state.u)[None],
                      vort[None], state.gp])


def write_plotfile(sim: Sim, state: State, istep: int, time: float,
                   dt: float, base: str = None):
    from . import boxlib
    name = f"{base or sim.cfg.plot_base_name}{istep:05d}"
    fields = _whole(sim, _plot_stack(state, sim.fill_vel(state.u), sim.dx,
                                     sim.ng, sim.n_cell, sim.phys_bc))
    if not pmesh.is_io_proc():
        _written()
        return name
    coarsen = 1
    if sim.cfg.coarsen_plot_data:
        # 2x cell-average restriction before writing (reference
        # coarsen_plot_data branch, varden.f90:548-573, nlevs=1 only)
        fields = restrict_cells(fields, sim.dm)
        coarsen = 2
    boxlib.write_plotfile(name, sim, _to_host([fields])[0],
                          plot_field_names(sim), time, coarsen=coarsen)
    _written()
    return name


def _write_chk_header(name, time, dt, nlevs):
    """Reference Header: Fortran namelist + per-level ref ratios
    (checkpoint.f90:66-79)."""
    with open(os.path.join(name, "Header"), "w") as f:
        f.write("&CHKPOINT\n")
        f.write(" time = %.17g\n" % float(time))
        f.write(" dt = %.17g\n" % float(dt))
        f.write(f" nlevs = {nlevs}\n")
        f.write("/\n")
        for _ in range(nlevs - 1):
            f.write(" 2\n")


def _wrap_nodal(p: np.ndarray, pmask):
    """Duplicate the wrap node on periodic axes: the nodal tensors carry n
    nodes there, FBoxLib multifabs n+1 (the +1 point per nodalized axis);
    the spatial axes are the trailing len(pmask)."""
    dm = len(pmask)
    for d, per in enumerate(pmask):
        ax = p.ndim - dm + d
        if per:
            p = np.concatenate([p, np.take(p, [0], axis=ax)], axis=ax)
    return p


def _unwrap_nodal(p: np.ndarray, pmask, n_cell):
    """Inverse of _wrap_nodal: drop the duplicated wrap node on periodic
    axes where present (reference-written checkpoints always have it)."""
    dm = len(pmask)
    for d, per in enumerate(pmask):
        ax = p.ndim - dm + d
        if per and p.shape[ax] == n_cell[d] + 1:
            p = np.take(p, range(n_cell[d]), axis=ax)
    return p


def _read_chk_header(name):
    with open(os.path.join(name, "Header")) as f:
        txt = f.read()
    time = float(re.search(r"time\s*=\s*([^\s,]+)", txt).group(1))
    dt = float(re.search(r"dt\s*=\s*([^\s,]+)", txt).group(1))
    nlevs = int(re.search(r"nlevs\s*=\s*(\d+)", txt).group(1))
    return time, dt, nlevs


def _istep_of(name):
    m = re.search(r"(\d+)$", name.rstrip("/"))
    return int(m.group(1)) if m else 0


def write_checkpoint(sim: Sim, state: State, istep: int, time: float,
                     dt: float, base: str = None,
                     hints: Dict[str, torch.Tensor] = None):
    """BoxLib-layout checkpoint directory (reference checkpoint.f90:14-83):
    the Header namelist, the State multifab ([u|s|gp], 2*dm+nscal
    components) and the nodal Pressure multifab; the projections' warm
    starts in hints.npz."""
    from . import boxlib
    name = f"{base or sim.cfg.check_base_name}{istep:05d}"
    keys = list(hints) if hints is not None else []
    whole = ([_whole(sim, torch.cat([state.u, state.s, state.gp])),
              _whole(sim, state.p, nodal=True)]
             + [_whole(sim, hints[k], nodal=k.startswith("phi_hg"))
                for k in keys])
    if not pmesh.is_io_proc():
        _written()
        return name
    os.makedirs(name, exist_ok=True)
    chk, p, *h = _to_host(whole)
    boxlib.write_multifab(os.path.join(name, "State", "Level_0"),
                          np.asarray(chk, np.float64))
    boxlib.write_multifab(os.path.join(name, "Pressure", "Level_0"),
                          _wrap_nodal(np.asarray(p, np.float64)[None],
                                      sim.pmask), nodal=True)
    if hints is not None:
        np.savez(os.path.join(name, "hints.npz"), **dict(zip(keys, h)))
    _write_chk_header(name, time, dt, 1)
    write_job_info(name, sim)
    _written()
    return name


def read_checkpoint(sim: Sim, name: str):
    """reference checkpoint_read (checkpoint.f90:85-145) +
    fill_restart_data. Returns (State, header dict, hints or None), the
    tensors on sim's device in its dtype (every rank reads the files and
    keeps its block of a decomposed run)."""
    from . import boxlib
    time, dt, _nlevs = _read_chk_header(name)
    chk, _lo, _ = boxlib.read_multifab(os.path.join(name, "State", "Level_0"))
    p, _plo, nodal = boxlib.read_multifab(
        os.path.join(name, "Pressure", "Level_0"))
    if not nodal:
        raise ValueError(f"{name}: the Pressure multifab must be nodal")
    p = _unwrap_nodal(p, sim.pmask, chk.shape[1:])
    dm, nscal = sim.dm, sim.nscal
    state = State(u=_block(sim, sim.tensor(chk[:dm])),
                  s=_block(sim, sim.tensor(chk[dm:dm + nscal])),
                  gp=_block(sim, sim.tensor(chk[dm + nscal:2 * dm + nscal])),
                  p=_block(sim, sim.tensor(p[0]), nodal=True))
    header = {"time": time, "dt": dt, "nlevs": 1, "istep": _istep_of(name),
              "n_cell": list(chk.shape[1:]), "dim": dm}
    hints = None
    hp = os.path.join(name, "hints.npz")
    if os.path.exists(hp):
        with np.load(hp) as data:
            hints = {k: _block(sim, sim.tensor(data[k]),
                               nodal=k.startswith("phi_hg"))
                     for k in data.files}
    return state, header, hints


def write_plotfile_ml(geom, states, istep: int, time: float,
                      base: str = None):
    """Multi-level BoxLib plotfile (reference varden.f90:492-592): one FAB
    per patch, patches grouped by depth into Level_d multifabs (gathered
    from the blocks onto rank 0, which writes)."""
    from . import boxlib
    from ..amr.fill import pad_ml_multi
    sim = geom.sim
    name = f"{base or sim.cfg.plot_base_name}{istep:05d}"
    u_l = [st.u for st in states]
    stacks = [geom.gather(l, _plot_stack(
        states[l], pad_ml_multi(geom, u_l, list(range(sim.dm)), l, sim.ng),
        geom.dx(l), sim.ng, geom.bn(l), geom.phys_bc_block(l)))
        for l in range(geom.nlev)]
    if not pmesh.is_io_proc():
        _written()
        return name
    arrays = _to_host(stacks)
    level_fields = [[(arrays[i], list(geom.specs[i].lo))
                     for i in geom.nodes_at(d)]
                    for d in range(1, geom.ndepth)]
    boxlib.write_plotfile(name, sim, arrays[0], plot_field_names(sim), time,
                          level_fields=level_fields)
    _written()
    return name


def write_checkpoint_ml(geom, states, istep: int, time: float, dt: float,
                        base: str = None, hints=None):
    """Multi-level BoxLib-layout checkpoint: State/Pressure ml-multifab
    directories with one Level_d subdirectory per depth (reference
    checkpoint.f90:14-83 via fabio_ml_multifab_write_d). ``hints`` (per-patch
    projection warm starts) go to hints.npz, so that a restarted run
    reproduces the original bitwise (the reference's restart regression
    requires exact agreement, Util/regression_testing/VARDEN-tests.ini
    bubble-restart)."""
    from . import boxlib
    sim = geom.sim
    name = f"{base or sim.cfg.check_base_name}{istep:05d}"
    keys = [(k, l) for l in range(geom.nlev) for k in (hints or {})]
    whole = ([geom.gather(l, torch.cat([st.u, st.s, st.gp]))
              for l, st in enumerate(states)]
             + [geom.gather(l, st.p, True) for l, st in enumerate(states)]
             + [geom.gather(l, hints[k][l], k.startswith("phi_hg"))
                for k, l in keys])
    if not pmesh.is_io_proc():
        _written()
        return name
    os.makedirs(name, exist_ok=True)
    host = _to_host(whole)
    chk, p, h = (host[:geom.nlev], host[geom.nlev:2 * geom.nlev],
                 host[2 * geom.nlev:])
    for d in range(geom.ndepth):
        st_boxes, p_boxes = [], []
        for i in geom.nodes_at(d):
            lo = list(geom.specs[i].lo)
            st_boxes.append((np.asarray(chk[i], np.float64), lo))
            # a patch wraps only on axes it fully spans (side_kind 'per')
            p_boxes.append((_wrap_nodal(np.asarray(p[i], np.float64)[None],
                                        geom.pmask_level(i)), lo))
        boxlib.write_multifab_boxes(os.path.join(name, "State", f"Level_{d}"),
                                    st_boxes)
        boxlib.write_multifab_boxes(
            os.path.join(name, "Pressure", f"Level_{d}"), p_boxes,
            nodal=True)
    if hints is not None:
        np.savez(os.path.join(name, "hints.npz"),
                 **{f"{k}_{l}": a for (k, l), a in zip(keys, h)})
    _write_chk_header(name, time, dt, geom.ndepth)
    write_job_info(name, sim)
    _written()
    return name


def read_checkpoint_ml(sim: Sim, name: str):
    """Rebuild the patch tree from the stored per-depth boxarrays (the
    reference's fill_restart_data role, restart.f90:15-50): each box at
    depth d parents to the depth-(d-1) box containing it. Returns (MLGeom,
    per-patch States, header dict, hints or None); under a mesh every rank
    reads the files and keeps its blocks."""
    from . import boxlib
    from ..amr.fill import MLGeom
    time, dt, nlevs = _read_chk_header(name)
    dm, nscal = sim.dm, sim.nscal
    specs, parent, depth, states = [], [], [], []
    for d in range(nlevs):
        st_boxes, _ = boxlib.read_multifab_boxes(
            os.path.join(name, "State", f"Level_{d}"))
        p_boxes, nodal = boxlib.read_multifab_boxes(
            os.path.join(name, "Pressure", f"Level_{d}"))
        if not nodal:
            raise ValueError(f"{name}: the Pressure multifab must be nodal")
        for (chk, lo), (p, _plo) in zip(st_boxes, p_boxes):
            nl = chk.shape[1:]
            if d == 0:
                par = -1
            else:
                par = next(j for j in range(len(specs))
                           if depth[j] == d - 1 and all(
                               specs[j].lo[t] * 2 <= lo[t] and
                               lo[t] + nl[t] <= specs[j].hi[t] * 2
                               for t in range(dm)))
            dn = [sim.n_cell[t] * 2 ** d for t in range(dm)]
            pm_l = [sim.pmask[t] and lo[t] == 0 and lo[t] + nl[t] == dn[t]
                    for t in range(dm)]
            p = _unwrap_nodal(p, pm_l, nl)
            specs.append(LevelSpec(tuple(lo), tuple(nl)))
            parent.append(par)
            depth.append(d)
            states.append(State(u=sim.tensor(chk[:dm]),
                                s=sim.tensor(chk[dm:dm + nscal]),
                                gp=sim.tensor(chk[dm + nscal:]),
                                p=sim.tensor(p[0])))
    geom = MLGeom(sim, specs, parent, depth)
    # each rank keeps its blocks
    states = [State(u=geom.block(l, st.u), s=geom.block(l, st.s),
                    gp=geom.block(l, st.gp), p=geom.block(l, st.p, True))
              for l, st in enumerate(states)]
    header = {"time": time, "dt": dt, "nlevs": nlevs,
              "istep": _istep_of(name), "n_cell": list(sim.n_cell),
              "dim": dm, "specs": [[list(s.lo), list(s.n)] for s in specs]}
    hints = None
    hp = os.path.join(name, "hints.npz")
    if os.path.exists(hp):
        with np.load(hp) as data:
            def part(key, l):
                return geom.block(l, sim.tensor(data[f"{key}_{l}"]),
                                  key.startswith("phi_hg"))

            hints = {k: [part(k, l) for l in range(geom.nlev)]
                     for k in ("phi_mac", "phi_hg")}
            # the extrapolation pair; a checkpoint without it restarts with
            # prev = the last solution (no extrapolation for one step)
            for k in ("phi_mac", "phi_hg"):
                kp = f"{k}_prev"
                hints[kp] = ([part(kp, l) for l in range(geom.nlev)]
                             if f"{kp}_0" in data.files else list(hints[k]))
    return geom, states, header, hints


def write_job_info(dirname: str, sim: Sim):
    """Provenance dump (reference write_job_info.f90:54-144): the run's
    parameters, the source revision, the torch device and the card."""
    info = {"params": dataclasses.asdict(sim.cfg)}
    try:
        info["git"] = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["git"] = "unknown"
    info["device"] = str(sim.device)
    info["card"] = (torch.cuda.get_device_name(sim.device)
                    if sim.device.type == "cuda" else None)
    info["torch"] = torch.__version__
    with open(os.path.join(dirname, "job_info"), "w") as f:
        json.dump(info, f, indent=1)
