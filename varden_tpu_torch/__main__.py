"""Program entry: the reference's main program (src/main.f90:1-56).

Usage:
    python -m varden_tpu_torch [inputs_file] [--key value ...] [--device D]

Reads a reference-format &PROBIN namelist, applies --key value overrides
(probin.template:107-126), runs the simulation on the card (or on
``--device cpu``) and reports the wall time and peak device memory.

The inputs file is located with the reference's 3-way priority
(probin.template:72-105): the $PROBIN environment variable, then the first
non-flag command-line argument, then ./inputs_varden.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = None
    if argv and not argv[0].startswith("-"):
        path = argv[0]
        argv = argv[1:]
    env = os.environ.get("PROBIN")
    if env:
        if path is not None and path != env:
            print(f"warning: $PROBIN={env} overrides the inputs-file "
                  f"argument '{path}' (unset PROBIN to use the argument)")
        path = env
    elif path is None and os.path.exists("inputs_varden"):
        path = "inputs_varden"
    if path is None:
        print(__doc__)
        print("error: no inputs file ($PROBIN, argument, or ./inputs_varden)")
        return 1
    if len(argv) % 2:
        print(f"error: option {argv[-1]} has no value")
        return 1
    overrides = {argv[i].lstrip("-"): argv[i + 1]
                 for i in range(0, len(argv), 2)}
    device = overrides.pop("device", None)

    import torch
    from .config import VardenConfig
    from .driver import run_from_inputs
    from .parallel import mesh as pmesh
    defaults = VardenConfig()
    fields = {f.name for f in dataclasses.fields(VardenConfig)}
    typed = {}
    for k, v in overrides.items():
        if k not in fields:
            print(f"warning: unknown parameter --{k}")
            continue
        cur = getattr(defaults, k)
        typed[k] = (v.lower() in ("t", "true", ".true.", "1")
                    if isinstance(cur, bool) else type(cur)(v))

    t0 = time.perf_counter()
    v = run_from_inputs(path, device=device, **typed)
    if v.sim.device.type == "cuda":
        torch.cuda.synchronize()
    if not pmesh.is_io_proc():  # rank 0 reports a decomposed run
        return 0
    print(f"Run time = {time.perf_counter() - t0:.6f}")
    if v.sim.device.type == "cuda":
        print(f"[{torch.cuda.get_device_name(v.sim.device)}] peak bytes "
              f"allocated={torch.cuda.max_memory_allocated(v.sim.device)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
