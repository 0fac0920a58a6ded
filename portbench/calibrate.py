#!/usr/bin/env python3
"""Readings from which a cell's limits are set: the program's compared
numbers over many seeds, and the float32 control's, in one process on the
card (the kernels built and the CUDA context made once).

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --controls 3 --seconds 3 [--first-seed 1000] > readings.jsonl

One JSON line a run: the seed, the dtype, ``compared`` and the run's
steps. The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    args = ap.parse_args(argv)
    import torch
    from portbench import cell as cell_mod
    from portbench import harness
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    cell = cell_mod.resolve(args.workload)
    runs = ([("float64", args.first_seed + k) for k in range(args.seeds)]
            + [("float32", args.first_seed + k)
               for k in range(args.controls)])
    for dtype, seed in runs:
        t0 = time.perf_counter()
        out = harness.run(cell, seed, args.seconds, False, dtype=dtype)
        print(json.dumps({"seed": seed, "dtype": dtype,
                          "correct": out["correct"],
                          "steps": out["attempted"],
                          "failed": out["failed"],
                          "wall_s": time.perf_counter() - t0,
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "compared": {k: v["value"] for k, v in
                                       out["compared"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
