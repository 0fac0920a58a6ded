"""Run chip_smoke.py's phase 16 or 17 alone on the card: the decomposed
single-level path (16) or AMR under a mesh (17) on gloo ranks sharing
cuda:0, each cell against its one-rank run and each rank's kernel calls
against their plain versions (chip_smoke.phase_decomposed,
chip_smoke.phase_decomposed_amr).

    python tools/torch_decomp_phase.py [--cells check,rt,headline,2d]
    python tools/torch_decomp_phase.py --phase 17 \
        [--cells cfg5,cfg5-full,cfg3,rt-io]

The cells are chip_smoke.decomp_cells()'s (16) or amr_decomp_cells()'s
(17). Run from a checkout's root.
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
        print("torch_decomp_phase: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", type=int, choices=(16, 17), default=16)
    ap.add_argument("--cells", default=None)
    ap.add_argument("--json", metavar="FILE",
                    help="write the phase's results here")
    args = ap.parse_args()
    cells = cs.decomp_cells() if args.phase == 16 else cs.amr_decomp_cells()
    keys = args.cells.split(",") if args.cells else list(cells)
    from varden_tpu_torch.ops import _cuda
    print(f"card: {cs.smi_name_power()}", flush=True)
    _cuda.build_all()
    cs.count_cycles()
    t0 = time.perf_counter()
    try:
        run = (cs.phase_decomposed if args.phase == 16
               else cs.phase_decomposed_amr)
        out = run(torch, keys)
    except cs.PhaseError as e:
        print(f"torch_decomp_phase: FAILED: {e}", flush=True)
        return 1
    print(f"torch_decomp_phase: ok, phase {args.phase} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
