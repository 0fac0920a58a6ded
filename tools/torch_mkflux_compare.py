#!/usr/bin/env python3
"""Kernels 11 (mkflux_3d_fused) and 2 (mkflux_update_3d_fused) from the
checkout's varden_tpu_torch/csrc beside another version of those files, on
one card, at chip_smoke.py's phase-2 shapes.

    python3 tools/torch_mkflux_compare.py NAME=DIR [NAME=DIR ...]
        [--sizes 256,240,384] [--dtypes float32,float64] [--reps 10]
        [--no-plain]

Each DIR holds another version's mkflux.cu, mkflux_update.cu and their
headers (an earlier commit's csrc: `git archive REV varden_tpu_torch/csrc
| tar -x -C tree_check/parent`). A staged mkflux.cu (the kernel before
its brick pass) takes a work tensor of 12 padded fields a component: it
is given one. Every version is built with the package's nvcc flags and
-Xptxas -v into varden_tpu_torch/_build/variants/ and swapped in for the
package's own libraries; the checkout's is the first version. Each case
is timed in turns, the versions in order and then in reverse (A B B A). The inputs are chip_smoke.py's: kernel_cases_amr at each
size (config 5's Sim, walls at the 256^3 base, coarse-fine sides on the
finer patches) and, at 256^3, kernel_cases' calls of kernel 2.

Prints the card's name and power limit, each build's registers, shared
memory and spills, then one JSON line per case and dtype: each version's
two device times (ms, CUDA events, mean of --reps calls after a
warm-up), whether each version's outputs equal the checkout's bit for
bit (or, for kernel 11, each output's error against the checkout's
relative to its largest value), and for kernel 11 each output's error
against the plain version and the peak device memory of the plain call
(skipped with --no-plain).
"""
import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from varden_tpu_torch.ops import _cuda  # noqa: E402

LIBS = ("mkflux", "mkflux_update")
KERNELS = {"mkflux_3d_fused": "mkflux",
           "mkflux_update_3d_fused": "mkflux_update"}


def build(tag, csrc, name, outdir):
    so = os.path.join(outdir, f"lib{name}_{tag}.so")
    r = subprocess.run([_cuda.nvcc(), *_cuda.FLAGS, "-Xptxas", "-v", "-o",
                        so, os.path.join(csrc, name + ".cu")],
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {tag} {name}:\n{r.stderr}")
    info = [ln.strip() for ln in r.stderr.splitlines()
            if "Used" in ln or "spill" in ln]
    L = ctypes.CDLL(so)
    L.vt_error_string.argtypes = [ctypes.c_int]
    L.vt_error_string.restype = ctypes.c_char_p
    with open(os.path.join(csrc, name + ".cu")) as f:
        L.vt_staged = "launch_mk_stages" in f.read()
    return L, info


def staged_shim(call):
    """_cuda.call for a staged kernel 11: its ptrs gain the work tensor
    before umax."""
    def shim(name, entry, ptrs, iv, dv, like):
        if name == "mkflux" and getattr(_cuda._libs[name], "vt_staged",
                                        False):
            s = ptrs[0]
            work = torch.empty((12 * s.shape[0],) + tuple(s.shape[1:]),
                               dtype=s.dtype, device=s.device)
            ptrs = list(ptrs[:12]) + [work, ptrs[12]]
        return call(name, entry, ptrs, iv, dv, like)
    return shim


def rel_errs(out, ref):
    return [e / max(sc, 1e-30) for e, sc in cs.max_errs(out, ref)]


def flat(x):
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in flat(y)]
    return [] if x is None else [x]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--sizes", default="256,240,384")
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-plain", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    outdir = os.path.join(_cuda.BUILD, "variants")
    os.makedirs(outdir, exist_ok=True)
    versions = [("checkout", _cuda.CSRC)] + [tuple(v.split("=", 1))
                                             for v in args.others]
    libs, ptxas = {}, {}
    for tag, csrc in versions:
        for name in LIBS:
            libs[tag, name], ptxas[f"{tag} {name}"] = build(tag, csrc, name,
                                                            outdir)
    print(json.dumps({"card": cs.smi_name_power(), "ptxas": ptxas}),
          flush=True)
    _cuda.call = staged_shim(_cuda.call)
    tags = [t for t, _ in versions]
    for dt in args.dtypes.split(","):
        for n in map(int, args.sizes.split(",")):
            sources = [functools.partial(cs.kernel_cases_amr,
                                         shapes=[(n,) * 3])]
            if n == 256:
                sources.append(cs.kernel_cases)
            for src in sources:
                for name, case, kern, plain, *_ in src(torch, dt):
                    if name not in KERNELS:
                        continue
                    lib = KERNELS[name]
                    row = dict(kernel=name, case=case, dtype=dt,
                               ms={t: [] for t in tags})
                    outs = {}
                    for tag in tags + tags[::-1]:
                        _cuda._libs[lib] = libs[tag, lib]
                        if tag not in outs:
                            outs[tag] = flat(kern())
                        row["ms"][tag].append(
                            cs.cuda_ms(torch, kern, args.reps))
                    ref = outs.pop("checkout")
                    for tag, out in outs.items():
                        if name == "mkflux_update_3d_fused":
                            row[f"bitwise_{tag}"] = all(
                                torch.equal(a, b) for a, b in zip(out, ref))
                        else:
                            row[f"errs_vs_{tag}"] = rel_errs(out, ref)
                    outs.clear()
                    if name == "mkflux_3d_fused" and not args.no_plain:
                        torch.cuda.reset_peak_memory_stats()
                        want = flat(plain())
                        row["plain_peak_gb"] = \
                            torch.cuda.max_memory_allocated() / 1e9
                        row["errs_vs_plain"] = rel_errs(ref, want)
                        del want
                    del ref
                    torch.cuda.empty_cache()
                    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
