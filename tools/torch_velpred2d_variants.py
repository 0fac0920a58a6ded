#!/usr/bin/env python3
"""Time kernel 9 (velpred_2d_fused) from the checkout's
varden_tpu_torch/csrc/velpred2d.cu beside variants of its tile plan, on one
card, at the 2-D main path's 4096^2.

    python3 tools/torch_velpred2d_variants.py [--n 4096]
        [--dtypes float32,float64] [VARIANT ...]

Each VARIANT is the file with its tile plan (PlanV2For: cells a tile along
each axis, threads a block) edited, built with the package's nvcc flags
into varden_tpu_torch/_build/variants/ and swapped in for the package's
own library:

  source    the file as it is (32 x 32 tiles; 256 threads in float32,
            512 in float64);
  t16       float32 tiles of 16 x 64, float64 16 x 32, 256 threads (the
            first plan);
  t16nt512  the same tiles, 512 threads;
  t8        float32 8 x 128, float64 8 x 64, 256 threads;
  big512    float32 32 x 64, float64 32 x 32, 512 threads.

The inputs are chip_smoke.py's phase-2 case "walls": the wall-bounded 2-D
bubble's Sim at n^2, smooth seeded u and force. Prints the card's name and
power limit, each build's registers and spills (ptxas), then one JSON line
per variant and dtype: device ms (CUDA events, mean of --reps calls after
a warm-up, the tie epsilon's launch included) and each face set's largest
error against the plain version.
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

PLAN = ("PlanV2<32, 32, 256>", "PlanV2<32, 32, 512>")  # float32, float64
VARIANTS = {
    "source": PLAN,
    "t16": ("PlanV2<16, 64, 256>", "PlanV2<16, 32, 256>"),
    "t16nt512": ("PlanV2<16, 64, 512>", "PlanV2<16, 32, 512>"),
    "t8": ("PlanV2<8, 128, 256>", "PlanV2<8, 64, 256>"),
    "big512": ("PlanV2<32, 64, 512>", "PlanV2<32, 32, 512>"),
}


def build(name, outdir):
    with open(os.path.join(_cuda.CSRC, "velpred2d.cu")) as f:
        text = f.read()
    for old, new in zip(PLAN, VARIANTS[name]):
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    text = text.replace('#include "grid2d.cuh"',
                        f'#include "{_cuda.CSRC}/grid2d.cuh"')
    cu = os.path.join(outdir, f"velpred2d_{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    so = os.path.join(outdir, f"libvelpred2d_{name}.so")
    r = subprocess.run([_cuda.nvcc(), *_cuda.FLAGS, "-Xptxas", "-v", "-o",
                        so, cu], capture_output=True, text=True, timeout=240)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stderr}")
    info = [ln.strip() for ln in r.stderr.splitlines()
            if "Used" in ln or "spill" in ln]
    L = ctypes.CDLL(so)
    L.vt_error_string.argtypes = [ctypes.c_int]
    L.vt_error_string.restype = ctypes.c_char_p
    return L, info


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--n", type=int, default=cs.N_2D)
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.state import Sim
    outdir = os.path.join(_cuda.BUILD, "variants")
    os.makedirs(outdir, exist_ok=True)
    libs = {name: build(name, outdir) for name in args.variants}
    print(json.dumps({"card": cs.smi_name_power(),
                      "ptxas": {k: v[1] for k, v in libs.items()}}),
          flush=True)
    for dt in args.dtypes.split(","):
        sim = Sim(VardenConfig(**cs.bubble2d_kw(args.n, dt)), device="cuda")
        dev, dt_, ng, N = sim.device, sim.dtype, sim.ng, sim.n_cell
        u = cs.smooth(torch, (2,) + N, 21, 0.5, dev, dt_, dm=2)
        f = cs.smooth(torch, (2,) + N, 22, 0.3, dev, dt_, dm=2)
        a = (sim.fill_vel(u), sim.fill_extrap(f, ng), 0.9 * sim.dx[0] / 0.5,
             sim.dx, sim.phys_bc, [sim.adv_bc[d] for d in range(2)], ng, N,
             sim.cfg.slope_order, sim.cfg.use_minion)
        ref = cg.velpred_2d_plain(*a)
        for name in args.variants:
            _cuda._libs["velpred2d"] = libs[name][0]
            out = cg.velpred_2d_fused(*a)
            errs = [float((o.double() - r.double()).abs().max())
                    / max(float(r.double().abs().max()), 1e-30)
                    for o, r in zip(out, ref)]
            ms = cs.cuda_ms(torch, lambda: cg.velpred_2d_fused(*a), args.reps)
            print(json.dumps(dict(variant=name, dtype=dt, n=args.n, ms=ms,
                                  errs=errs)), flush=True)
        del a, ref, sim
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
