#!/usr/bin/env python3
"""Phase profile of config 3's geometry (2-D bubble, BENCH_N^2 base + 1
level, float32) on the card: the whole composite step (differenced) and
then profiling.profile_phases_ml's phase split.

    BENCH_N=64 python3 tools/torch_profile_amr2d.py [--device cpu]

The counterpart of tools/profile_amr2d.py (see torch_profile_amr.py).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_profile_amr import VardenConfig, profile  # noqa: E402

if __name__ == "__main__":
    n = int(os.environ.get("BENCH_N", "64"))
    profile(VardenConfig(
        dim_in=2, prob_type=1, n_cellx=n, n_celly=n, max_levs=2,
        regrid_int=4, grav=-9.8, visc_coef=1e-3, cflfac=0.9,
        init_shrink=0.1, init_iter=1, max_step=0, dtype="float32",
        bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15), 2, 12, 10)
