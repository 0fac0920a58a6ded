#!/usr/bin/env python3
"""Time the port's headline and AMR steps, and optionally kernel 2, in the
checkout this is run from, so that two checkouts can be compared on one
card in one call.

    cd CHECKOUT && python3 /path/to/tools/torch_step_compare.py TAG [--kernel2]

It imports chip_smoke.py and varden_tpu_torch from the current directory
(the checkout under test, which may be an older commit unpacked with `git
archive`) and drives that checkout's own phase functions: the headline
configuration (the viscous 256^3 bubble, float32, STEPS steps) and
BASELINE config 5 (256^3 + 2 levels, float32, STEPS_AMR steps), with the
same gates as chip_smoke.py. It prints one line "RESULT TAG {json}" with
each step's seconds, the steady mean, and the launches of kernels 2, 6 and
11 per step. With --kernel2 it first times kernel 2's phase-2 cases (256^3,
and config 5's patches with the flux option where the checkout has them)
against the plain version. Run the two checkouts in turns (A, B, B, A):
the host's share of a step varies from run to run.
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from varden_tpu_torch.config import VardenConfig  # noqa: E402
from varden_tpu_torch.ops import _cuda  # noqa: E402

KERNELS = ("mkflux_update_3d_fused", "update_3d", "mkflux_3d_fused")


def kernel2_only(cases_fn):
    return lambda torch_, dtype: [c for c in cases_fn(torch_, dtype)
                                  if c[0] == "mkflux_update_3d_fused"]


def main():
    if not torch.cuda.is_available():
        print("torch_step_compare: no CUDA device", file=sys.stderr)
        return 1
    tag = sys.argv[1]
    print(f"card: {cs.smi_name_power()}", flush=True)
    _cuda.build_all()
    if "--kernel2" in sys.argv:
        for dtype in ("float32", "float64"):
            reps = cs.REPS if dtype == "float32" else cs.REPS // 4
            for fn in (cs.kernel_cases, cs.kernel_cases_amr):
                cs.phase_kernels(torch, dtype, reps, kernel2_only(fn))
                torch.cuda.empty_cache()
    _, _, _, steps, _ = cs.phase_main(
        torch, cs.bubble_kw(256, "float32", visc_coef=1.0e-3), cs.STEPS,
        cs.KERNELS_3D)
    torch.cuda.empty_cache()
    _, _, _, steps_amr, _, init = cs.phase_main_ml(
        torch, VardenConfig(**cs.cfg5_kw(256, "float32")), cs.STEPS_AMR,
        cs.KERNELS_AMR, "config 5")
    torch.cuda.empty_cache()
    out = {"headline_steps_s": [r["seconds"] for r in steps],
           "headline_steady_s": cs.mean_steady(steps),
           "cfg5_steps_s": [r["seconds"] for r in steps_amr],
           "cfg5_steady_s": cs.mean_steady(steps_amr), "cfg5_init_s": init}
    for key, ps in (("headline", steps), ("cfg5", steps_amr)):
        out[f"{key}_launches_per_step"] = {
            k: [r["launches"][k] for r in ps] for k in KERNELS}
    print(f"RESULT {tag} {json.dumps(out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
