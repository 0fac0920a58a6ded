"""Run chip_smoke.py's phase 19 alone on the card: the eight quick workloads
of varden_tpu_torch.regression in float64 with their checks, launches and
recorded kernel calls, each workload's first steps on the card against the
CPU plain path, and the 2-D ones in float32 against float64
(chip_smoke.phase_regression).

    python tools/torch_regression_phase.py [--json FILE]

Run from a checkout's root.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_regression_phase: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", metavar="FILE",
                    help="write the phase's results here")
    args = ap.parse_args()
    from varden_tpu_torch.ops import _cuda
    print(f"card: {cs.smi_name_power()}", flush=True)
    _cuda.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.count_cycles()
    t0 = time.perf_counter()
    try:
        out = cs.phase_regression(torch)
    except cs.PhaseError as e:
        print(f"torch_regression_phase: FAILED: {e}", flush=True)
        return 1
    print(f"torch_regression_phase: ok, phase 19 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
