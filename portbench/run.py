#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1``
also ``breakdown``; ``compared`` last: each number the reference check
compared, with its limit). The compared numbers are also the last lines of
standard error. With ``--trace 0`` the metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics.

The float32 control that the check has to fail runs from
portbench/calibrate.py, never from here.

Exits non-zero without a result when no CUDA device is present (there is
no CPU fallback), when the cell asks for more devices than there are, or
when jax, jaxlib, flax or varden_tpu is loaded once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import cell as cell_mod
    from portbench import harness

    work = {w["name"]: w for w in cell_mod.benchmark()["workloads"]}
    if args.workload not in work:
        print(f"run.py: no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    chips = work[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    cell = cell_mod.resolve(args.workload)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: the process loaded {found}", file=sys.stderr)
        return 3
    for k, c in out["compared"].items():
        print(f"compared {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
