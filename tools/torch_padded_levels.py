#!/usr/bin/env python3
"""Time a V-cycle's visit of one periodic-x MAC level (kernel 7's route) in
the checkout this is run from, at every size config 4's and the RT inputs'
hierarchies reach and at 256^3, in both dtypes.

    cd CHECKOUT && python3 /path/to/tools/torch_padded_levels.py TAG \
        [--sizes 16,32,64,128,256] [--dtypes float32,float64] [--reps 20]

It imports chip_smoke.py and varden_tpu_torch from the current directory
and prints, after the card's name and power limit, one JSON line per level
and dtype: the level is config 4's MAC operator at n^3 (chip_smoke.rt_level:
beta = 1/rho on faces of the Rayleigh-Taylor density, periodic x and y,
Neumann z), and a visit is ck.FUSED_SWEEPS sweeps, the residual, its 2x2x2
restriction and max|r|, then the piecewise-constant prolongation of a
coarse correction, its add and ck.FUSED_SWEEPS sweeps. Two ways:

  "single"  the composition a V-cycle ran before kernel 7's fused stages:
            mg._pad_ghost and the padded sweep (two launches) a sweep,
            kernel 3's restrict emit, ck.cell_prolong and the add;
  "fused"   kernel 7's fused stages, smooth_restrict then smooth with the
            correction (one launch a sweep), where the checkout has them,
            with the equality of every output to the single passes'.

Device ms: CUDA events around --reps visits after a warm-up, so on a level
whose launches outrun the host the time is the host's dispatch.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from varden_tpu_torch.ops import _cuda  # noqa: E402
from varden_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from varden_tpu_torch.solvers import mg  # noqa: E402


def visits(n, dtype_name):
    """(single visit, fused visit or None) on config 4's level at n^3."""
    lev, ell_bc, phi, rhs = cs.rt_level(torch, n, dtype_name)
    bv = [[0.0, 0.0]] * 3
    nsw = ck.FUSED_SWEEPS
    corr = cs.smooth(torch, (n // 2,) * 3, 52, 0.1, phi.device, phi.dtype)
    g = (rhs, lev.inv_diag, list(lev.beta), lev.dx)

    def sweeps(p):
        for _ in range(nsw):
            p = ck.gsrb_sweep_3d(mg._pad_ghost(p, ell_bc, bv, 3), *g)
        return p

    def single():
        p = sweeps(phi)
        crs, rmax = ck.gsrb_var_sweep_3d(p, rhs, lev.inv_diag, lev.beta,
                                         lev.dx, ell_bc, bv, emit="restrict")
        return p, crs, rmax, sweeps(p + ck.cell_prolong(corr, (2, 2, 2)))

    if not hasattr(ck.gsrb_sweep_3d, "fused_launches"):
        return single, None
    kw = dict(ell_bc=ell_bc, bvals=bv, nsweeps=nsw)

    def fused():
        p, crs, rmax = ck.gsrb_sweep_3d(phi, *g, emit="smooth_restrict", **kw)
        return p, crs, rmax, ck.gsrb_sweep_3d(p, *g, emit="smooth",
                                              corr=corr, **kw)

    return single, fused


def main():
    if not torch.cuda.is_available():
        print("torch_padded_levels: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag")
    ap.add_argument("--sizes", default="16,32,64,128,256")
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    print(f"card: {cs.smi_name_power()}", flush=True)
    _cuda.build_all()
    for dtype_name in args.dtypes.split(","):
        for n in map(int, args.sizes.split(",")):
            single, fused = visits(n, dtype_name)
            rec = {"tag": args.tag, "n": n, "dtype": dtype_name,
                   "single_ms": cs.cuda_ms(torch, single, args.reps)}
            if fused is not None:
                rec["fused_ms"] = cs.cuda_ms(torch, fused, args.reps)
                rec["speedup"] = rec["single_ms"] / rec["fused_ms"]
                rec["equal"] = all(torch.equal(a, b)
                                   for a, b in zip(single(), fused()))
            print("LEVEL " + json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
