"""BoxLib/AMReX-format plotfile and multifab writer and reader (counterpart
of varden_tpu.io.boxlib).

Produces the directory layout the reference emits through fabio
(fabio_ml_multifab_write_d, consumed at varden.f90:568-573): a
HyperCLaw-V1.1 text Header plus per-level Cell_H multifab headers and Cell_D
FAB data files, so outputs can be read by amrvis/yt/AMReX tooling and
diffed against the Fortran code's plotfiles.

Arrays here are numpy, indexed [x, y(, z)] in C order; FAB files store
Fortran order (x fastest), so the bytes are written from the transposed
view. This is the byte stream of varden_tpu's native FAB writer
(csrc/fabio.cpp), written and read with numpy alone.
"""
from __future__ import annotations

import os
import re
import sys
from typing import List, Sequence

import numpy as np

# IEEE float64 descriptor + byte order of the bytes actually written (native):
# AMReX/FBoxLib emit "(8 7 6 5 4 3 2 1)" on little-endian x86.
_ORDER = ("(8, (8 7 6 5 4 3 2 1))" if sys.byteorder == "little"
          else "(8, (1 2 3 4 5 6 7 8))")
_FAB_HEADER = f"FAB ((8, (64 11 52 0 1 12 0 1023)),{_ORDER})"
_BOX_RE = re.compile(r"\(\(([^)]*)\)\s*\(([^)]*)\)\s*\(([^)]*)\)\)")


def _box_str(lo, hi, nodal=False):
    dm = len(lo)
    t = ",".join(("1" if nodal else "0") for _ in range(dm))
    return "({}) ({}) ({})".format(
        ",".join(str(i) for i in lo), ",".join(str(i) for i in hi), t)


def write_multifab_boxes(level_dir: str, boxes, nodal: bool = False,
                         prefix: str = "Cell"):
    """Write a multifab with one FAB file per box (the reference's fabio
    layout: one grid per FAB, varden.f90:568-573 / checkpoint.f90:44-48).

    boxes: list of (data (ncomp, *n) float64, lo). ``nodal`` stamps the
    index type bits (each box then spans lo..hi inclusive on the node
    lattice: hi = lo + n - 1)."""
    os.makedirs(level_dir, exist_ok=True)
    ncomp = boxes[0][0].shape[0]
    dm = boxes[0][0].ndim - 1
    box_lines, fab_lines = [], []
    mins = [[float(np.min(data[c])) for c in range(ncomp)]
            for data, _ in boxes]
    maxs = [[float(np.max(data[c])) for c in range(ncomp)]
            for data, _ in boxes]
    for b, (data, lo) in enumerate(boxes):
        n = data.shape[1:]
        lo = list(lo) if lo is not None else [0] * dm
        hi = [lo[d] + n[d] - 1 - (1 if nodal else 0) for d in range(dm)]
        box_lines.append("(%s)" % _box_str(lo, hi, nodal))
        fab_path = os.path.join(level_dir, f"{prefix}_D_{b:05d}")
        # AMReX FAB header line: "FAB (...)((lo) (hi) (type)) ncomp"
        hdr = f"{_FAB_HEADER}({_box_str(lo, hi, nodal)}) {ncomp}\n"
        with open(fab_path, "wb") as f:
            f.write(hdr.encode())
            # Fortran order, component slowest
            arr = np.ascontiguousarray(
                np.stack([np.asarray(data[c], np.float64).T
                          for c in range(ncomp)]))
            f.write(arr.tobytes())
        fab_lines.append(f"FabOnDisk: {prefix}_D_{b:05d} 0")

    with open(os.path.join(level_dir, f"{prefix}_H"), "w") as f:
        f.write("1\n1\n%d\n0\n" % ncomp)
        f.write("(%d 0\n%s\n)\n" % (len(boxes), "\n".join(box_lines)))
        f.write("%d\n" % len(boxes))
        f.write("\n".join(fab_lines) + "\n")
        f.write("\n%d,%d\n" % (len(boxes), ncomp))
        for row in mins:
            f.write(",".join(f"{v:.16e}" for v in row) + ",\n")
        f.write("\n%d,%d\n" % (len(boxes), ncomp))
        for row in maxs:
            f.write(",".join(f"{v:.16e}" for v in row) + ",\n")


def write_multifab(level_dir: str, data: np.ndarray, lo=None,
                   nodal: bool = False, prefix: str = "Cell"):
    """One dense grid as a single-FAB multifab (Cell_H + Cell_D_00000).
    data: (ncomp, *n) float64."""
    write_multifab_boxes(level_dir, [(data, lo)], nodal=nodal, prefix=prefix)


def read_multifab(level_dir: str, prefix: str = "Cell"):
    """Multifab reader assembling all boxes onto their bounding box.
    Returns (arr (ncomp, *n), lo, nodal) where ``lo`` is the bbox smallend
    and ``n`` spans the bbox (nodal boxes get their +1 point per axis)."""
    per_box, nodal = read_multifab_boxes(level_dir, prefix)
    dm = per_box[0][0].ndim - 1
    ncomp = per_box[0][0].shape[0]
    blo = [min(lo[d] for _a, lo in per_box) for d in range(dm)]
    bhi = [max(lo[d] + a.shape[1 + d] for a, lo in per_box)
           for d in range(dm)]
    n = tuple(bhi[d] - blo[d] for d in range(dm))
    out = np.zeros((ncomp,) + n, np.float64)
    for a, lo in per_box:
        sl = tuple(slice(lo[d] - blo[d], lo[d] - blo[d] + a.shape[1 + d])
                   for d in range(dm))
        out[(slice(None),) + sl] = a
    return out, blo, nodal


def read_multifab_boxes(level_dir: str, prefix: str = "Cell"):
    """General multifab reader: a multi-FAB (multi-box) Cell_H with per-FAB
    file/offset entries. Returns ([(arr (ncomp, *bn), lo), ...], nodal): one
    entry per box (nodal boxes carry their +1 point per axis)."""
    with open(os.path.join(level_dir, f"{prefix}_H")) as f:
        lines = f.read().split("\n")
    i = 2
    ncomp = int(lines[i].split()[0])
    i = 4
    # BoxArray: "(N M" then N box lines then ")"
    first = lines[i].strip()
    if not first.startswith("("):
        raise ValueError(f"bad boxarray line: {first!r}")
    nbox = int(first.strip("(").split()[0])
    i += 1
    boxes = []
    for _ in range(nbox):
        m = _BOX_RE.search(lines[i])
        i += 1
        boxes.append(([int(v) for v in m.group(1).split(",")],
                      [int(v) for v in m.group(2).split(",")],
                      [int(v) for v in m.group(3).split(",")]))
    if lines[i].strip() != ")":
        raise ValueError(f"bad boxarray end: {lines[i]!r}")
    i += 1
    nfab = int(lines[i].split()[0])
    i += 1
    fabs = []
    for _ in range(nfab):
        parts = lines[i].split()
        i += 1
        if parts[0] != "FabOnDisk:":
            raise ValueError(f"bad FabOnDisk line: {lines[i - 1]!r}")
        fabs.append((parts[1], int(parts[2])))

    dm = len(boxes[0][0])
    nodal = boxes[0][2][0] == 1
    ext = 1 if nodal else 0
    out = []
    for (lo, hi, _t), (fname, off) in zip(boxes, fabs):
        bn = tuple(hi[d] - lo[d] + 1 + ext for d in range(dm))
        with open(os.path.join(level_dir, fname), "rb") as f:
            f.seek(off)
            fhdr = f.readline().decode()
            m = _BOX_RE.search(fhdr)
            fnc = int(fhdr[m.end():].split()[0])
            # the FAB's own box may be grown by ghost cells relative to the
            # valid box in the multifab header: its extents set the strides
            flo = [int(v) for v in m.group(1).split(",")]
            fhi = [int(v) for v in m.group(2).split(",")]
            fbn = tuple(fhi[d] - flo[d] + 1 + ext for d in range(dm))
            raw = np.frombuffer(f.read(8 * fnc * int(np.prod(fbn))),
                                np.float64)
        # byte order from the FAB real descriptor; byteswap if it differs
        # from this host's (AMReX stamps the writing machine's order)
        file_little = "(8 7 6 5 4 3 2 1)" in fhdr
        if file_little != (sys.byteorder == "little"):
            raw = raw.byteswap()
        arr = raw.reshape((fnc,) + tuple(reversed(fbn)))
        arr = np.stack([arr[c].T for c in range(fnc)])
        # crop the FAB to its valid box; C order, as the kernels take it
        vsl = tuple(slice(lo[d] - flo[d], lo[d] - flo[d] + bn[d])
                    for d in range(dm))
        out.append((np.ascontiguousarray(arr[(slice(None),) + vsl][:ncomp]),
                    list(lo)))
    return out, nodal


def write_plotfile(name: str, sim, fields: np.ndarray,
                   field_names: Sequence[str], time: float,
                   level_fields: List = None, ref_ratio: int = 2,
                   coarsen: int = 1):
    """Write a plotfile directory. ``fields``: (ncomp, *n) for level 0;
    finer levels in ``level_fields``, each a list of (array, lo) boxes (one
    FAB per patch, the reference's fabio layout, varden.f90:568-573).
    ``coarsen``: the data was cell-averaged by this factor before the call
    (reference coarsen_plot_data, varden.f90:548-573)."""
    dm = sim.dm
    ncomp = fields.shape[0]
    levels = [[(fields, [0] * dm)]] + [list(lf) for lf in level_fields or []]
    nlev = len(levels)
    os.makedirs(name, exist_ok=True)
    prob_lo, prob_hi = sim.cfg.prob_lo, sim.cfg.prob_hi
    dx0 = tuple(h * coarsen for h in sim.dx)
    n_cell0 = tuple(s // coarsen for s in sim.n_cell)

    with open(os.path.join(name, "Header"), "w") as f:
        f.write("HyperCLaw-V1.1\n")
        f.write(f"{ncomp}\n")
        for nm in field_names:
            f.write(nm + "\n")
        f.write(f"{dm}\n")
        f.write(f"{time:.16e}\n")
        f.write(f"{nlev - 1}\n")
        f.write(" ".join(f"{v:.16e}" for v in prob_lo) + " \n")
        f.write(" ".join(f"{v:.16e}" for v in prob_hi) + " \n")
        f.write(" ".join(str(ref_ratio) for _ in range(nlev - 1)) + " \n")
        dom = []
        for lev in range(nlev):
            # the level's problem domain box (reference plotfile semantics)
            hi = [n_cell0[d] * ref_ratio ** lev - 1 for d in range(dm)]
            dom.append("((%s) (%s) (%s))" % (
                ",".join("0" for _ in range(dm)),
                ",".join(str(v) for v in hi),
                ",".join("0" for _ in range(dm))))
        f.write(" ".join(dom) + " \n")
        f.write(" ".join("0" for _ in range(nlev)) + " \n")
        for lev in range(nlev):
            dxl = [h / ref_ratio ** lev for h in dx0]
            f.write(" ".join(f"{h:.16e}" for h in dxl) + " \n")
        f.write("0\n0\n")
        for lev, boxes in enumerate(levels):
            dxl = [h / ref_ratio ** lev for h in dx0]
            f.write(f"{lev} {len(boxes)} {time:.16e}\n")
            f.write("0\n")
            for arr, lo in boxes:
                n = arr.shape[1:]
                for d in range(dm):
                    xlo = prob_lo[d] + lo[d] * dxl[d]
                    xhi = prob_lo[d] + (lo[d] + n[d]) * dxl[d]
                    f.write(f"{xlo:.16e} {xhi:.16e}\n")
            f.write(f"Level_{lev}/Cell\n")

    for lev, boxes in enumerate(levels):
        write_multifab_boxes(
            os.path.join(name, f"Level_{lev}"),
            [(np.asarray(arr, np.float64), lo) for arr, lo in boxes])


def read_plotfile(name: str):
    """Read back a plotfile (multi-box levels assembled onto their bounding
    boxes). Returns (field_names, time, [level arrays (ncomp, *n)])."""
    with open(os.path.join(name, "Header")) as f:
        lines = [ln.rstrip("\n") for ln in f]
    ncomp = int(lines[1])
    names = lines[2:2 + ncomp]
    i = 2 + ncomp + 1
    time = float(lines[i])
    finest = int(lines[i + 1])
    levels = [read_multifab(os.path.join(name, f"Level_{lev}"))[0]
              for lev in range(finest + 1)]
    return names, time, levels
