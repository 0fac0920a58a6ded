"""Run chip_smoke.py's phase 16 alone on the card: the decomposed
single-level path on gloo ranks sharing cuda:0, each cell against its
one-rank run and each rank's kernel calls against their plain versions
(chip_smoke.phase_decomposed).

    python tools/torch_decomp_phase.py [--cells check,rt,headline,2d]

The cells are chip_smoke.decomp_cells()'s. Run from a checkout's root.
"""
from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_decomp_phase: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(cs.decomp_cells()))
    args = ap.parse_args()
    from varden_tpu_torch.ops import _cuda
    print(f"card: {cs.smi_name_power()}", flush=True)
    _cuda.build_all()
    try:
        cs.phase_decomposed(torch, args.cells.split(","))
    except cs.PhaseError as e:
        print(f"torch_decomp_phase: FAILED: {e}", flush=True)
        return 1
    print("torch_decomp_phase: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
