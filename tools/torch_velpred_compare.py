#!/usr/bin/env python3
"""Time kernel 1 (velpred_3d_fused) from the checkout's
varden_tpu_torch/csrc/velpred.cu beside other versions of that file, on
one card, at BASELINE config 5's level shapes.

    python3 tools/torch_velpred_compare.py [--sizes 256,240,384]
        [--dtypes float32,float64] [NAME=OLD.cu ...]

Each NAME=OLD.cu is built with the package's nvcc flags into
varden_tpu_torch/_build/variants/ and swapped in for the package's own
library (an earlier commit's file: `git show
REV:varden_tpu_torch/csrc/velpred.cu > old.cu`; an older file must take
the same arguments, and a staged one its work tensor: give it as
NAME=OLD.cu:work). The inputs are chip_smoke.py's: config 5's Sim at each
size n^3 (walls at the 256^3 base, coarse-fine sides on the finer
patches), smooth seeded u and force. Prints the card's name and power
limit, each build's registers and spills (ptxas), then one JSON line per
version, dtype and size: device ms (CUDA events, mean of --reps calls
after a warm-up), each face set's error against the plain version
(relative to its largest value) and the byte bound.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from varden_tpu_torch.ops import _cuda  # noqa: E402
from varden_tpu_torch.ops import cuda_godunov as cg  # noqa: E402


def build(name, path, outdir):
    cu = os.path.join(outdir, f"velpred_{name}.cu")
    with open(path) as f:
        text = f.read()
    with open(cu, "w") as f:
        for h in ("common.cuh", "mkflux3d.cuh"):
            text = text.replace(f'#include "{h}"',
                                f'#include "{_cuda.CSRC}/{h}"')
        f.write(text)
    so = os.path.join(outdir, f"libvelpred_{name}.so")
    r = subprocess.run([_cuda.nvcc(), *_cuda.FLAGS, "-Xptxas", "-v", "-o",
                        so, cu], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stderr}")
    info = [ln.strip() for ln in r.stderr.splitlines()
            if "Used" in ln or "spill" in ln]
    L = ctypes.CDLL(so)
    L.vt_error_string.argtypes = [ctypes.c_int]
    L.vt_error_string.restype = ctypes.c_char_p
    return L, info


def staged_call(a):
    """An older staged velpred (its work tensor of 24 padded fields)."""
    u, force, dt, dx, phys_bc, adv, ng, n, order, minion = a
    opts = dict(dtype=u.dtype, device=u.device)
    outs = [torch.empty(tuple(n[t] + (1 if t == d else 0) for t in range(3)),
                        **opts) for d in range(3)]
    work = torch.empty((24,) + tuple(s + 2 * ng for s in n), **opts)
    umax = torch.zeros(1, **opts)
    iv = [*n, ng, order, int(bool(minion))] + cg._flat_bc(phys_bc, adv)
    _cuda.call("velpred", "velpred3d", [u, force, *outs, work, umax], iv,
               [float(dt), *map(float, dx)], u)
    return tuple(outs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", metavar="NAME=OLD.cu[:work]")
    ap.add_argument("--sizes", default="256,240,384")
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from varden_tpu_torch.config import INTERIOR, VardenConfig
    from varden_tpu_torch.state import Sim
    outdir = os.path.join(_cuda.BUILD, "variants")
    os.makedirs(outdir, exist_ok=True)
    versions = {"checkout": (os.path.join(_cuda.CSRC, "velpred.cu"), False)}
    for spec in args.others:
        name, path = spec.split("=", 1)
        staged = path.endswith(":work")
        versions[name] = (path[:-5] if staged else path, staged)
    libs = {}
    for name, (path, staged) in versions.items():
        libs[name] = build(name, path, outdir)
    print(json.dumps({"card": cs.smi_name_power(),
                      "ptxas": {k: v[1] for k, v in libs.items()}}),
          flush=True)
    for dt in args.dtypes.split(","):
        for n in map(int, args.sizes.split(",")):
            sim = Sim(VardenConfig(**cs.cfg5_kw(n, dt)), device="cuda")
            dev, dt_, ng, N = sim.device, sim.dtype, sim.ng, sim.n_cell
            pbc = (sim.phys_bc if n == cs.N_AMR_PATCHES[0]
                   else ((INTERIOR, INTERIOR),) * 3)
            u = cs.smooth(torch, (3,) + N, 1, 0.5, dev, dt_)
            f = cs.smooth(torch, (3,) + N, 2, 0.3, dev, dt_)
            a = (sim.fill_vel(u), sim.fill_extrap(f, ng), 0.5 * sim.dx[0],
                 sim.dx, pbc, [sim.adv_bc[d] for d in range(3)], ng, N,
                 sim.cfg.slope_order, sim.cfg.use_minion)
            del u, f
            ref = cg.velpred_3d_plain(*a)
            moved = cs.nbytes(a[:2]) + cs.nbytes(ref)
            for name, (_path, staged) in versions.items():
                _cuda._libs["velpred"] = libs[name][0]

                def fn():
                    return staged_call(a) if staged else \
                        cg.velpred_3d_fused(*a)
                out = fn()
                errs = [float((o.double() - r.double()).abs().max())
                        / max(float(r.double().abs().max()), 1e-30)
                        for o, r in zip(out, ref)]
                del out
                ms = cs.cuda_ms(torch, fn, args.reps)
                print(json.dumps(dict(version=name, dtype=dt, n=n, ms=ms,
                                      errs=errs, bound_ms=moved
                                      / cs.MEM_BYTES_PER_S * 1e3)),
                      flush=True)
            del a, ref, sim
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
