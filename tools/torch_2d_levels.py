#!/usr/bin/env python3
"""Time the port's 2-D kernels in the checkout this is run from, so that two
checkouts (and variants of kernel 8's fused stages) can be compared on one
card in one call.

    cd CHECKOUT && python3 /path/to/tools/torch_2d_levels.py TAG \
        [--sizes 8,16,...] [--dtypes float32,float64] [VARIANT ...]

It imports chip_smoke.py and varden_tpu_torch from the current directory
(the checkout under test, which may be an older commit unpacked with `git
archive`) and prints, after the card's name and power limit, one JSON line
per measurement (device ms: CUDA events, mean of --reps calls after a
warm-up):

  "cases"  every 2-D case of that checkout's chip_smoke phase 2 at 4096^2
           (kernels 8, 9 and 10), its time and its largest error against
           the plain version relative to that output's largest value;
  "visit"  a V-cycle's visit of one level of kernel 8's operator (the MAC
           operator of a seeded density in [1, 2], Neumann walls; the
           coarse-fine ghost code on every side at config 3's 64^2 and 80^2)
           at every size of the 4096^2 hierarchy and at 64^2 and 80^2 (or
           --sizes): the single passes (two two-launch sweeps, the
           residual, the plain restriction and max|r|, the plain
           prolongation and add, two sweeps) and, where the checkout has
           them, the two fused stages (smooth_restrict, then smooth with
           the coarse correction), with the fused outputs' equality to the
           single passes'.

Each VARIANT is kernel 8's source (csrc/gsrb2d.cu) with one edit, built
with the package's nvcc flags into varden_tpu_torch/_build/variants/ and
swapped in for the fused visit (the single passes keep the checkout's own
library):

  source   the file as it is;
  t16      float32 tiles of 16 x 64 cells (half the shared memory);
  nt256    256 threads a block;
  u4       the stage's two load loops unrolled four times (more loads in
           flight a thread);
  batch    the load loops batched by hand: four (phi) and three
           (coefficients) strided iterations' loads into registers before
           their shared-memory stores.

A variant whose nvcc runs past 240 s is reported and skipped.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from varden_tpu_torch.ops import _cuda  # noqa: E402
from varden_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from varden_tpu_torch.solvers import mg  # noqa: E402

TILE = """  static constexpr int TX = sizeof(T) == 4 ? 32 : 16;
  static constexpr int TY = 64;
  static constexpr int NT = 512;"""
LOADS = ("  for (int c = tid; c < RC; c += NT) {",
         "  for (int c = tid; c < CC; c += NT) {")
# the load phase as it is, and batched: a few strided iterations' loads
# issued into registers before any of their shared-memory stores
LOAD_PHASE = """  for (int c = tid; c < RC; c += NT) {
    const int gx = gxt[c / RY], gy = gyt[c % RY];
    if (gx >= 0 && gy >= 0) {
      T v = phi[(i64)gx * n1 + gy];
      if (corr != nullptr)
        v = v + corr[(i64)(gx >> f.fsh[0]) * nc1 + (gy >> f.fsh[1])];
      buf[c] = v;
    }
  }
  // the coefficients of the updated cells
  for (int c = tid; c < CC; c += NT) {
    const int gx = gxt[c / CY + 1], gy = gyt[c % CY + 1];
    if (gx >= 0 && gy >= 0) {
      const i64 g = (i64)gx * n1 + gy;
      const i64 gb = g + gx;  // by is (n0, n1+1)
      co[CO_RHS * CC + c] = rhs[g];
      co[CO_INV * CC + c] = inv[g];
      co[CO_BXL * CC + c] = bx[g];
      co[CO_BXH * CC + c] = bx[g + n1];
      co[CO_BYL * CC + c] = by[gb];
      co[CO_BYH * CC + c] = by[gb + 1];
    }
  }"""
BATCHED = """  for (int c0 = tid; c0 < RC; c0 += 4 * NT) {
    T v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + u * NT;
      v[u] = (T)0;
      if (c < RC) {
        const int gx = gxt[c / RY], gy = gyt[c % RY];
        if (gx >= 0 && gy >= 0) {
          T w = phi[(i64)gx * n1 + gy];
          if (corr != nullptr)
            w = w + corr[(i64)(gx >> f.fsh[0]) * nc1 + (gy >> f.fsh[1])];
          v[u] = w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c0 + u * NT < RC) buf[c0 + u * NT] = v[u];
  }
  for (int c0 = tid; c0 < CC; c0 += 3 * NT) {
    T q[3][6];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int c = c0 + u * NT;
#pragma unroll
      for (int k = 0; k < 6; ++k) q[u][k] = (T)0;
      if (c < CC) {
        const int gx = gxt[c / CY + 1], gy = gyt[c % CY + 1];
        if (gx >= 0 && gy >= 0) {
          const i64 g = (i64)gx * n1 + gy;
          const i64 gb = g + gx;
          q[u][CO_RHS] = rhs[g];
          q[u][CO_INV] = inv[g];
          q[u][CO_BXL] = bx[g];
          q[u][CO_BXH] = bx[g + n1];
          q[u][CO_BYL] = by[gb];
          q[u][CO_BYH] = by[gb + 1];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 3; ++u)
      if (c0 + u * NT < CC) {
#pragma unroll
        for (int k = 0; k < 6; ++k) co[k * CC + c0 + u * NT] = q[u][k];
      }
  }"""
VARIANTS = {
    "t16": lambda s: s.replace(TILE, TILE.replace("? 32 : 16", "? 16 : 16")),
    "nt256": lambda s: s.replace(TILE, TILE.replace("NT = 512", "NT = 256")),
    "u4": lambda s: s.replace(LOADS[0], "#pragma unroll 4\n" + LOADS[0])
                     .replace(LOADS[1], "#pragma unroll 4\n" + LOADS[1]),
    "batch": lambda s: s.replace(LOAD_PHASE, BATCHED),
}
SIZES = (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8, 80)


def build(name, outdir):
    src = open(os.path.join(_cuda.CSRC, "gsrb2d.cu")).read()
    if name != "source":
        if TILE not in src or LOAD_PHASE not in src:
            raise SystemExit("csrc/gsrb2d.cu does not hold the text a "
                             "variant edits: update this tool")
        src = VARIANTS[name](src)
    cu = os.path.join(outdir, f"gsrb2d_{name}.cu")
    with open(cu, "w") as f:
        f.write(src.replace('#include "common.cuh"',
                            f'#include "{_cuda.CSRC}/common.cuh"'))
    so = os.path.join(outdir, f"libgsrb2d_{name}.so")
    try:
        r = subprocess.run([_cuda.nvcc(), *_cuda.FLAGS, "-Xptxas", "-v",
                            "-o", so, cu], capture_output=True, text=True,
                           timeout=240)
    except subprocess.TimeoutExpired:
        return None, ["nvcc ran past 240 s"], []
    if r.returncode:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{r.stderr}")
    regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                   for ln in r.stderr.splitlines() if "Used" in ln})
    spills = sorted({ln.split(",")[1].strip() for ln in r.stderr.splitlines()
                     if "spill stores" in ln})
    L = ctypes.CDLL(so)
    L.vt_error_string.argtypes = [ctypes.c_int]
    L.vt_error_string.restype = ctypes.c_char_p
    return L, regs, spills


def rel_errs(out, ref):
    out = out if isinstance(out, (tuple, list)) else (out,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    return [e / max(sc, 1e-30) for e, sc in cs.max_errs(tuple(out),
                                                         tuple(ref))]


def level(n, dtype):
    """Kernel 8's operator at n^2 and the visit's inputs."""
    dev = torch.device("cuda")
    ell = [(3, 3)] * 2 if n in (64, 80) else [(1, 1)] * 2
    N = (n, n)
    rho = 1.5 + 0.5 * cs.smooth(torch, N, 90, 1.0, dev, dtype, dm=2)
    beta = []
    for d in range(2):
        lo = [slice(None)] * 2
        hi = [slice(None)] * 2
        lo[d], hi[d] = slice(0, 1), slice(n - 1, n)
        q = torch.cat([rho[tuple(lo)], rho, rho[tuple(hi)]], dim=d)
        beta.append((2.0 / (q.narrow(d, 0, n + 1)
                            + q.narrow(d, 1, n + 1))).contiguous())
    lev = mg.make_level(N, (1.0 / n,) * 2, ell,
                        torch.zeros(N, dtype=dtype, device=dev), tuple(beta),
                        0.0)
    phi = cs.smooth(torch, N, 91, 0.5, dev, dtype, dm=2)
    rhs = cs.smooth(torch, N, 92, 50.0, dev, dtype, dm=2)
    corr = cs.smooth(torch, (n // 2,) * 2, 93, 0.1, dev, dtype, dm=2)
    return (phi, rhs, lev.inv_diag, lev.beta, lev.dx, ell,
            [[0.0, 0.0]] * 2), corr


def single_visit(g, corr):
    """A level visit as the generic branch of mg.v_cycle ran it."""
    p = g[0]
    for _ in range(2):
        p = ck.gsrb_sweep_2d(p, *g[1:])
    r = ck.gsrb_sweep_2d(p, *g[1:], emit="residual")
    crs, rmax = mg._cell_avg_down(r, 2), r.abs().max()
    p = p + ck.cell_prolong(corr, (2, 2))
    for _ in range(2):
        p = ck.gsrb_sweep_2d(p, *g[1:])
    return p, crs, rmax


def fused_visit(g, corr):
    p, crs, rmax = ck.gsrb_sweep_2d(*g, emit="smooth_restrict", nsweeps=2)
    p = ck.gsrb_sweep_2d(p, *g[1:], emit="smooth", nsweeps=2, corr=corr,
                         cfac=(2, 2))
    return p, crs, rmax


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag")
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_2d_levels: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.smi_name_power()}", flush=True)
    _cuda.build_all()
    fused = "smooth_restrict" in getattr(ck, "_EMITS_2D", ())
    own = _cuda.lib("gsrb2d")
    libs = {"source": (own, [], [])}
    names = args.variants if fused else []
    if [n for n in names if n != "source"]:
        outdir = os.path.join(_cuda.BUILD, "variants")
        os.makedirs(outdir, exist_ok=True)
        with ThreadPoolExecutor(len(names)) as ex:
            libs.update(zip(names, ex.map(lambda n: build(n, outdir),
                                          names)))
        print(json.dumps({"tag": args.tag, "ptxas": {
            n: {"registers": b[1], "spills": b[2]}
            for n, b in libs.items()}}), flush=True)
        names = [n for n in names if libs[n][0] is not None]
    names = names or (["source"] if fused else [])
    for dt in args.dtypes.split(","):
        reps = args.reps if dt == "float32" else max(2, args.reps // 4)
        for name, case, kern, plain, *_ in cs.kernel_cases_2d(torch, dt):
            row = dict(tag=args.tag, what="cases", name=name, case=case,
                       dtype=dt, errs=rel_errs(kern(), plain()),
                       ms=cs.cuda_ms(torch, kern, reps))
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
        for n in map(int, args.sizes.split(",")):
            g, corr = level(n, getattr(torch, dt))
            row = dict(tag=args.tag, what="visit", n=n, dtype=dt,
                       single_ms=cs.cuda_ms(
                           torch, lambda: single_visit(g, corr), reps))
            old = single_visit(g, corr)
            for name in names:
                _cuda._libs["gsrb2d"] = libs[name][0]
                out = fused_visit(g, corr)
                row[f"{name}_equal"] = all(torch.equal(o, r)
                                           for o, r in zip(out, old))
                row[f"{name}_ms"] = cs.cuda_ms(
                    torch, lambda: fused_visit(g, corr), reps)
                row[f"{name}_smooth_restrict_ms"] = cs.cuda_ms(
                    torch, lambda: ck.gsrb_sweep_2d(
                        *g, emit="smooth_restrict", nsweeps=2), reps)
                row[f"{name}_smooth_corr_ms"] = cs.cuda_ms(
                    torch, lambda: ck.gsrb_sweep_2d(
                        *g, emit="smooth", nsweeps=2, corr=corr), reps)
            _cuda._libs["gsrb2d"] = own
            print(json.dumps(row), flush=True)
            del g, corr, old
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
