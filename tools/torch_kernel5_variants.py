#!/usr/bin/env python3
"""Time variants of kernel 5's fused multigrid stages (gsrb_const_sweep_3d,
emits "smooth_restrict" and "smooth") side by side on one card, beside the
single passes a V-cycle's level visit called before them.

    python3 tools/torch_kernel5_variants.py [--against OLD.cu]
        [--sizes 32,64,...] [--dtypes float32,float64] [VARIANT ...]

Each variant is kernel 5's source (varden_tpu_torch/csrc/gsrb_const.cu)
with one edit, built with the package's nvcc flags into
varden_tpu_torch/_build/variants/ and swapped in for the package's own
library:

  source   the file as it is;
  lb2      the fused kernel asked to fit two blocks an SM
           (__launch_bounds__(NT, 2): at most 64 registers a thread);
  t32      tiles twice as high, 1024 threads a block;
  nocoef   no coefficient load in the fused stages (rhs, inv_diag and aco
           constants; timing only: the values are wrong);
  against  OLD.cu as it is (--against; e.g. an earlier commit's file,
           `git show REV:varden_tpu_torch/csrc/gsrb_const.cu > old.cu`).

The operator is the viscous one of the headline (rho - mu lap on a seeded
density, Dirichlet on every face); B = 3 and B = 1 fields at each size n^3.
Prints the card's name and power limit, then one JSON line per variant,
dtype, size and B: device ms (CUDA events, mean of --reps launches after a
warm-up) of `smooth_restrict` and of `smooth` with a coarse correction
(two sweeps each, as the V-cycles call them), of one fast-path sweep (a
40-sweep `smooth`, divided by 40), each output's error against the plain
version (relative to its largest value), the single passes that the two
stages replace (`old_visit_ms`: two two-launch sweeps, the residual, the
plain restriction and max|r|, the plain prolongation and add, two
sweeps) and one two-launch sweep (`old_sweep_ms`, its error against the
plain version in `sweep_errs`).
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from varden_tpu_torch.ops import _cuda  # noqa: E402
from varden_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from varden_tpu_torch.solvers import mg  # noqa: E402

LB = "__global__ void __launch_bounds__(NT)\n    const_fused_kernel("
LB2 = "__global__ void __launch_bounds__(NT, 2)\n    const_fused_kernel("
TILE = "static constexpr int TY = sizeof(T) == 4 ? 16 : 8;"
TILE2 = "static constexpr int TY = sizeof(T) == 4 ? 32 : 16;"
NT = "static constexpr int NT = 512;"
NT2 = "static constexpr int NT = 1024;"
LOADS = """  q.rhs = rhs[g];
  q.inv = with_inv ? inv[g] : (T)0;
  q.aco = aco != nullptr ? aco[g] : (T)0;"""
NOCOEF = """  q.rhs = (T)0.5;
  q.inv = with_inv ? (T)1e-3 : (T)0;
  q.aco = (T)2;"""
EXACT = ("source", "lb2", "t32", "against")


def sources(path, against):
    src = open(path).read()
    for old in (LB, TILE, NT, LOADS):
        if old not in src:
            raise SystemExit(f"{path} does not hold the text a variant "
                             "edits: update this tool")
    out = {"source": src, "lb2": src.replace(LB, LB2),
           "t32": src.replace(TILE, TILE2).replace(NT, NT2),
           "nocoef": src.replace(LOADS, NOCOEF)}
    if against:
        out["against"] = open(against).read()
    return out


def build(name, text, outdir):
    cu = os.path.join(outdir, f"gsrb_const_{name}.cu")
    with open(cu, "w") as f:
        f.write(text.replace('#include "common.cuh"',
                             f'#include "{_cuda.CSRC}/common.cuh"'))
    so = os.path.join(outdir, f"libgsrb_const_{name}.so")
    r = subprocess.run([_cuda.nvcc(), *_cuda.FLAGS, "-Xptxas", "-v", "-o",
                        so, cu], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{r.stderr}")
    regs = [ln.split("Used")[1].split(",")[0].strip()
            for ln in r.stderr.splitlines() if "Used" in ln]
    spills = [ln.split(",")[1].strip() for ln in r.stderr.splitlines()
              if "spill stores" in ln]
    return so, regs, sorted(set(spills))


def use(so):
    """Route the package's gsrb_const calls to library ``so``."""
    L = ctypes.CDLL(so)
    L.vt_error_string.argtypes = [ctypes.c_int]
    L.vt_error_string.restype = ctypes.c_char_p
    _cuda._libs["gsrb_const"] = L


def errs(out, ref):
    return [float((o.double() - r.double()).abs().max())
            / max(float(r.double().abs().max()), 1e-30)
            for o, r in zip(out if isinstance(out, tuple) else (out,),
                            ref if isinstance(ref, tuple) else (ref,))]


def inputs(n, B, dtype):
    dev = torch.device("cuda")
    N = (n,) * 3
    dx = (1.0 / n,) * 3
    rho = 5.5 + 4.5 * cs.smooth(torch, N, 70, 1.0, dev, dtype)
    mu = 0.5 * dx[0] * 1.0e-3
    lev = mg.make_level(N, dx, [(2, 2)] * 3, rho, (mu,) * 3, 1.0)
    coef = [mu / h ** 2 for h in dx] + [1.0]
    phi = cs.smooth(torch, (B,) + N, 71, 0.5, dev, dtype)
    rhs = cs.smooth(torch, (B,) + N, 72, 2.0, dev, dtype)
    corr = cs.smooth(torch, (B,) + (n // 2,) * 3, 73, 0.1, dev, dtype)
    return (phi, rhs, lev.inv_diag, coef, [(2, 2)] * 3,
            [[0.0, 0.0]] * 3), dict(aco=rho), corr


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--against", metavar="OLD.cu")
    ap.add_argument("--sizes", default="32,64,128,240,256,384")
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    texts = sources(os.path.join(_cuda.CSRC, "gsrb_const.cu"), args.against)
    names = args.variants or list(texts)
    outdir = os.path.join(_cuda.BUILD, "variants")
    os.makedirs(outdir, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(
            lambda n: build(n, texts[n], outdir), names)))
    print(json.dumps({"card": cs.smi_name_power(),
                      "ptxas": {n: {"registers": b[1], "spills": b[2]}
                                for n, b in built.items()}}), flush=True)
    for dt in args.dtypes.split(","):
        dtype = getattr(torch, dt)
        for n in map(int, args.sizes.split(",")):
            for B in (3, 1):
                g, kw, corr = inputs(n, B, dtype)
                stages = {
                    "smooth_restrict": lambda: ck.gsrb_const_sweep_3d(
                        *g, emit="smooth_restrict", nsweeps=2, **kw),
                    "smooth+corr": lambda: ck.gsrb_const_sweep_3d(
                        *g, emit="smooth", nsweeps=2, corr=corr, **kw)}
                refs = {
                    "smooth_restrict": ck.gsrb_const_sweep_3d_plain(
                        *g, emit="smooth_restrict", nsweeps=2, **kw),
                    "smooth+corr": ck.gsrb_const_sweep_3d_plain(
                        *g, emit="smooth", nsweeps=2, corr=corr, **kw)}
                for name in names:
                    use(built[name][0])
                    row = dict(variant=name, dtype=dt, n=n, B=B)
                    for case, fn in stages.items():
                        if name in EXACT:
                            row[f"{case}_errs"] = errs(fn(), refs[case])
                        row[f"{case}_ms"] = cs.cuda_ms(torch, fn, args.reps)
                    row["fast_sweep_ms"] = cs.cuda_ms(
                        torch, lambda: ck.gsrb_const_sweep_3d(
                            *g, emit="smooth", nsweeps=40, **kw),
                        max(1, args.reps // 4)) / 40
                    row["old_visit_ms"] = cs.cuda_ms(
                        torch, lambda: old_visit(g, kw, corr), args.reps)
                    row["old_sweep_ms"] = cs.cuda_ms(
                        torch, lambda: ck.gsrb_const_sweep_3d(*g, **kw),
                        args.reps)
                    row["sweep_errs"] = errs(
                        ck.gsrb_const_sweep_3d(*g, **kw),
                        ck.gsrb_const_sweep_3d_plain(*g, **kw))
                    print(json.dumps(row), flush=True)
                del g, kw, corr, refs
                torch.cuda.empty_cache()
    return 0


def old_visit(g, kw, corr):
    """A level visit as the generic branch of mg.v_cycle ran it."""
    phi, rhs, _inv, coef, ell, bv = g
    p = phi
    for _ in range(2):
        p = ck.gsrb_const_sweep_3d(p, *g[1:], **kw)
    r = ck.gsrb_const_sweep_3d(p, rhs, None, coef, ell, bv, emit="residual",
                               **kw)
    crs, rmax = mg._cell_avg_down(r, 3), r.abs().max()
    p = p + ck.cell_prolong(corr, (2, 2, 2))
    for _ in range(2):
        p = ck.gsrb_const_sweep_3d(p, *g[1:], **kw)
    return p, crs, rmax


if __name__ == "__main__":
    sys.exit(main())
