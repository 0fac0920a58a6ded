#!/usr/bin/env python3
"""The density in the wall rows of a regression workload's final state.

    python tools/torch_wall_rows.py rt-3d [--full] [--dtype float32]
        [--device cpu]

Runs one workload of ``python -m varden_tpu_torch.regression`` (the same
runner, inputs and check; on the card unless ``--device cpu``) and prints
its check's result, then for every patch of every level the density's
range in each cell row on a wall of the domain (the first and the last row
along every non-periodic axis, named by its index on the level) and in the
patch's cells two or more rows from every wall (tests/torch_inputs.py
row_ranges), and the card's name and power limit.
"""
import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import pytest  # noqa: E402
import torch  # noqa: E402

from torch_inputs import row_ranges  # noqa: E402
from varden_tpu_torch import regression  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload", choices=list(regression.RUNNERS))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    args = ap.parse_args(argv)
    over = {} if args.dtype is None else {"dtype": args.dtype}
    seen = []
    checks = {"_check": regression._check, "_rt_check": regression._rt_check}

    def spy(name):
        def check(v, sts, *a):
            seen.append((v, regression._levels(sts)))
            return checks[name](v, sts, *a)
        return check

    with pytest.MonkeyPatch.context() as mp:
        for name in checks:
            mp.setattr(regression, name, spy(name))
        try:
            out = regression.run_workload(args.workload, args.full,
                                          args.device, **over)
            print(f"{args.workload}: check passed")
        except regression.CheckFailed as e:
            out = e.numbers
            print(f"{args.workload}: check failed: {e}")
    print(f"  {out['steps_run']} steps, {out['wall_s']:.3f} s wall, "
          f"rho by level {out.get('rho')}")
    v, levels = seen[-1]   # the check of the final state
    cfg = v.cfg
    boxes = regression._boxes(v)
    for i, (st, (lo, n)) in enumerate(zip(levels, boxes)):
        lev = v.geom.depth[i] if v.geom is not None else 0
        dom = [c * cfg.ref_ratio ** lev for c in cfg.n_cell]
        rr = row_ranges(regression._host(st.s[0]).numpy(), cfg.pmask, lo,
                        dom)
        print(f"  level {lev} patch lo {tuple(lo)} n {tuple(n)}: " +
              " ".join(f"{k} [{a:.6f}, {b:.6f}]" for k, (a, b) in rr.items()),
              flush=True)
    if torch.cuda.is_available():
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(f"  card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
