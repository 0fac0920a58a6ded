#!/usr/bin/env python3
"""Phase profile of the AMR bench configuration (3-D bubble, BENCH_N^3
base + 1 level, float32) on the card: the whole composite step (steps of
a fixed dt, a short run's seconds subtracted from a long one's) and then
profiling.profile_phases_ml's phase split.

    BENCH_N=64 python3 tools/torch_profile_amr.py [--device cpu]

The counterpart of tools/profile_amr.py; tools/torch_profile_amr2d.py
runs the 2-D one (config 3's geometry) through profile() below.
"""
import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from varden_tpu_torch import profiling  # noqa: E402
from varden_tpu_torch.amr import advance_ml  # noqa: E402
from varden_tpu_torch.config import VardenConfig  # noqa: E402
from varden_tpu_torch.driver import Varden  # noqa: E402

DT = 5e-4


def profile(cfg, k_short, k_long, n_rep):
    """Initialize ``cfg``'s hierarchy, time k_short and k_long composite
    steps of DT from it (best of two each), print the step's seconds and
    composite cells per second, then profile_phases_ml."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu for the plain path (default: the card)")
    args = ap.parse_args()
    v = Varden(cfg, device=args.device)
    states = v.initialize_ml()
    geom = v.geom
    print("tree:", [(geom.depth[i], geom.specs[i].n)
                    for i in range(geom.nlev)])

    def run(k):
        s = list(states)
        t0 = time.perf_counter()
        for _ in range(k):
            s, _diag = advance_ml.ml_advance(geom, s, DT, 4)
        if s[0].u.is_cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(1)
    t1 = min(run(k_short) for _ in range(2))
    t2 = min(run(k_long) for _ in range(2))
    per_step = (t2 - t1) / (k_long - k_short)
    dm = geom.dm
    fine = math.prod(geom.specs[1].n)
    cells = math.prod(geom.specs[0].n) + fine - fine // 2 ** dm
    print(f"WHOLE ML STEP: {1e3 * per_step:.2f} ms -> "
          f"{cells / per_step / 1e6:.2f} Mcells/s (composite cells {cells})")
    profiling.profile_phases_ml(geom, states, DT, n_rep=n_rep)


if __name__ == "__main__":
    n = int(os.environ.get("BENCH_N", "64"))
    profile(VardenConfig(
        dim_in=3, prob_type=1, n_cellx=n, n_celly=n, n_cellz=n, max_levs=2,
        regrid_int=-1, bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15,
        bcz_lo=15, bcz_hi=15, grav=-9.8, visc_coef=1e-3, cflfac=0.5,
        init_shrink=0.5, max_step=0, init_iter=0, dtype="float32"), 1, 5, 5)
