#!/usr/bin/env python3
"""Time variants of kernel 3's fused multigrid stages side by side on one
card.

    python3 tools/torch_kernel3_variants.py [--source FILE.cu] [VARIANT ...]

Each variant is kernel 3's source (varden_tpu_torch/csrc/gsrb_var.cu with
the header csrc/gsrb3d.cuh it includes, or FILE.cu, e.g. an earlier
commit's: `git show REV:varden_tpu_torch/csrc/gsrb_var.cu > old.cu`) with
one edit, built
with the package's nvcc flags into varden_tpu_torch/_build/variants/ and
swapped in for the package's own library; the cases are chip_smoke.py's
phase-2 fused stages (`smooth_restrict`, and `smooth` with a coarse
correction, two sweeps each) at 256^3, 240^3 and 384^3 in float32 and
float64:

  source      the file as it is (exact);
  contiguous  every coefficient load of the fused stages at cell index g/2,
              so that a warp's loads of a field are contiguous, as a
              colour-split layout would make them (timing only: the values
              are wrong);
  nocoef      no coefficient load at all (timing only);
  ty32        float32 tiles 32 rows high instead of 16 (exact; only by
              name: a kernel that takes one half-sweep pair a thread, as
              the current one does, refuses such a tile when it is built).

Without VARIANT names it runs the first three. Prints the card's name and
power limit, then one JSON line per variant, dtype and case: device ms
(CUDA events, mean of 20 launches after a warm-up), each output's max
abs error against the plain version for the exact variants, and for
`source` the time of the old single emits the stage replaces.
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

LOADS = """  q.b[0] = beta[0][g];
  q.b[1] = beta[0][g + (i64)n1 * n2];
  const i64 gb = g + (i64)gx * n2;  // beta[1] is (n0, n1+1, n2)
  q.b[2] = beta[1][gb];
  q.b[3] = beta[1][gb + n2];
  const i64 gc = g + (i64)gx * n1 + gy;  // beta[2] is (n0, n1, n2+1)
  q.b[4] = beta[2][gc];
  q.b[5] = beta[2][gc + 1];
  q.rhs = rhs[g];
  q.inv = with_inv ? inv[g] : (T)0;"""
# seven contiguous streams at g/2 (the offsets stay inside the arrays for
# n0 >= 200, as at every case's shape)
CONTIGUOUS = """  const i64 h = g >> 1, hf = (i64)n1 * n2 * 100;
  q.b[0] = beta[0][h];
  q.b[1] = beta[0][h + hf];
  q.b[2] = beta[1][h];
  q.b[3] = beta[1][h + hf];
  q.b[4] = beta[2][h];
  q.b[5] = beta[2][h + hf];
  q.rhs = rhs[g];
  q.inv = with_inv ? inv[h] : (T)0;"""
NOCOEF = """  for (int k = 0; k < 6; ++k) q.b[k] = (T)1 + (T)0.001 * k;
  q.rhs = rhs[g];
  q.inv = with_inv ? (T)1e-6 : (T)0;"""
TILE = "static constexpr int TY = sizeof(T) == 4 ? 16 : 8;"
TILE32 = "static constexpr int TY = sizeof(T) == 4 ? 32 : 8;"
EXACT = ("source", "ty32")


def sources(path):
    """The variants' texts: the kernel's source with the fused-stage header
    it includes (csrc/gsrb3d.cuh, where the edited text lives) inlined."""
    src = open(path).read()
    inc = '#include "gsrb3d.cuh"'
    if inc in src:
        with open(os.path.join(_cuda.CSRC, "gsrb3d.cuh")) as f:
            src = src.replace(inc, f.read().replace("#pragma once", ""))
    for old in (LOADS, TILE):
        if old not in src:
            raise SystemExit(f"{path} does not hold the text a variant "
                             "edits: update this tool")
    return {"source": src, "contiguous": src.replace(LOADS, CONTIGUOUS),
            "nocoef": src.replace(LOADS, NOCOEF),
            "ty32": src.replace(TILE, TILE32)}


def build(name, text, outdir):
    cu = os.path.join(outdir, f"gsrb_var_{name}.cu")
    with open(cu, "w") as f:
        f.write(text.replace('#include "common.cuh"',
                             f'#include "{_cuda.CSRC}/common.cuh"'))
    so = os.path.join(outdir, f"libgsrb_var_{name}.so")
    r = subprocess.run([_cuda.nvcc(), *_cuda.FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{r.stderr}")
    return so


def use(so):
    """Route the package's gsrb_var calls to library ``so``."""
    L = ctypes.CDLL(so)
    L.vt_error_string.argtypes = [ctypes.c_int]
    L.vt_error_string.restype = ctypes.c_char_p
    _cuda._libs["gsrb_var"] = L


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--source", metavar="FILE.cu",
                    default=os.path.join(_cuda.CSRC, "gsrb_var.cu"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    texts = sources(args.source)
    names = args.variants or ["source", "contiguous", "nocoef"]
    outdir = os.path.join(_cuda.BUILD, "variants")
    os.makedirs(outdir, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(zip(names, ex.map(
            lambda n: build(n, texts[n], outdir), names)))
    print(json.dumps({"card": cs.smi_name_power(), "source": args.source}),
          flush=True)
    for dt in ("float32", "float64"):
        for n in cs.N_AMR_PATCHES:
            cases = cs.smoother_cases(torch, dt, n)[:2]  # kernel 3's
            for name in names:
                if dt == "float64" and name == "ty32":
                    continue
                use(libs[name])
                for _k, case, kern, plain, _b, _ops, old in cases:
                    out = kern()
                    torch.cuda.synchronize()
                    row = dict(variant=name, dtype=dt, case=case)
                    if name in EXACT:
                        row["errs"] = [e for e, _ in cs.max_errs(out,
                                                                 plain())]
                    del out
                    row["ms"] = cs.cuda_ms(torch, kern, 20)
                    if name == "source":
                        row["old_emits_ms"] = cs.cuda_ms(torch, old, 20)
                    print(json.dumps(row), flush=True)
            del cases
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
