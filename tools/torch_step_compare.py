#!/usr/bin/env python3
"""Time the port's headline, AMR, Rayleigh-Taylor and 2-D steps in the checkout
this is run from, so that two checkouts can be compared on one card in one
call.

    cd CHECKOUT && python3 /path/to/tools/torch_step_compare.py TAG \
        [--cells headline,cfg5,rt,rtio,2d,pub1024,cfg3]

It imports chip_smoke.py and varden_tpu_torch from the current directory
(the checkout under test, which may be an older commit unpacked with `git
archive`) and drives that checkout's own phase functions, with the same
gates as chip_smoke.py: the headline configuration (the viscous 256^3
bubble, float32, STEPS steps), BASELINE config 5 (256^3 + 2 levels,
float32, STEPS_AMR steps), config 4 (3-D Rayleigh-Taylor 128^3, float32,
STEPS steps), the RT inputs as published (inputs/inputs_RayleighTaylor_3d:
float64, 32^3 base, 2 levels, regrid every step; RTIO_STEPS steps, no
output files, and no density gate: the problem leaves the bubble's
range), the 2-D main cell (the viscous 2-D bubble's geometry at
N_2D^2, float32, STEPS steps), the published viscous 2-D bubble at
N_2D_PUBLISHED^2 (float32, STEPS steps) and BASELINE config 3 (2-D 64^2,
2 levels, float32, 6 steps across a regrid), each (or those --cells
names) followed by one more step under torch.profiler. It prints one line "RESULT TAG {json}" with, per
configuration, each step's seconds and the steady mean, the kernel
launches of each step, the peak device memory, the V-cycles of the
single-level and composite solves (mg.v_cycle and nodal.v_cycle entered at
the finest level, initialization included), the outer cycles and solver
ratios of each step and,
of the profiled step, its wall seconds, the device's busy seconds and idle
share and the device milliseconds and launches of each of the package's
kernel functions. Run the two checkouts in turns (A, B, B, A):
the host's share of a step varies from run to run.
"""
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from varden_tpu_torch.config import VardenConfig  # noqa: E402
from varden_tpu_torch.ops import _cuda  # noqa: E402
from varden_tpu_torch.solvers import mg, nodal  # noqa: E402

CYCLES = collections.Counter()
RTIO_STEPS = 6


def count_cycles(module, key, lev_pos):
    """Count the V-cycles of ``module`` entered at the finest level (the
    recursion and the composite solves call the module's global)."""
    fn = module.v_cycle

    def wrapped(*a, **k):
        if k.get("lev", a[lev_pos] if len(a) > lev_pos else 0) == 0:
            CYCLES[key] += 1
        return fn(*a, **k)

    module.v_cycle = wrapped


def rt_inputs(nsteps):
    """The RT inputs as published, initialization and nsteps steps on the
    card: (Varden, states, per-step records, peak device bytes)."""
    from varden_tpu_torch.config import load_config
    from varden_tpu_torch.driver import Varden
    cfg = load_config(os.path.join("inputs", "inputs_RayleighTaylor_3d"),
                      plot_int=-1, chk_int=-1, max_step=nsteps)
    fns = cs.counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    v = Varden(cfg)
    states = v.initialize_ml()
    steps = []
    while v.istep < nsteps:
        before = cs.read_counts(fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = v.step_ml(states)
        torch.cuda.synchronize()
        d = v.last_diag
        rec = {"seconds": time.perf_counter() - t0,
               "launches": {k: c - before[k]
                            for k, c in cs.read_counts(fns).items()}}
        for k in ("mac_outer", "hg_outer", "mac_ratio", "hg_ratio",
                  "visc_ratio"):
            rec[k] = float(d[k]) if "ratio" in k else int(d[k])
        rec["visc_outer"] = [int(k) for k in d.get("visc_outer", [])]
        steps.append(rec)
    return v, states, steps, torch.cuda.max_memory_allocated()


def profiled(v, state):
    """One more step under torch.profiler: wall and busy seconds, and
    device ms and launches per kernel function of the package."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from varden_tpu_torch.advance import RANGES
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        (v.step_ml if v.ml else v.step)(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in RANGES]
    busy = sum(e.self_device_time_total for e in rows) * 1e-6
    own = collections.defaultdict(lambda: [0.0, 0])
    for e in rows:
        if " vt::" in e.key:
            name = e.key.split("vt::")[1].split("<")[0].split("(")[0]
            own[name][0] += e.self_device_time_total * 1e-3
            own[name][1] += e.count
    return {"wall_s": wall, "busy_s": busy, "idle_share": 1.0 - busy / wall,
            "own_ms": {k: {"ms": m, "launches": c} for k, (m, c)
                       in sorted(own.items())}}


def main():
    if not torch.cuda.is_available():
        print("torch_step_compare: no CUDA device", file=sys.stderr)
        return 1
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag")
    ap.add_argument("--cells",
                    default="headline,cfg5,rt,rtio,2d,pub1024,cfg3")
    args = ap.parse_args()
    tag = args.tag
    print(f"card: {cs.smi_name_power()}", flush=True)
    _cuda.build_all()
    count_cycles(mg, "mg", 4)
    count_cycles(nodal, "nodal", 3)
    # config 4's MAC levels take no fused stage of kernel 3
    rt_kw = {"fused": cs.FUSED_RT} if hasattr(cs, "FUSED_RT") else {}
    out = {}
    for key in args.cells.split(","):
        CYCLES.clear()
        if key == "headline":
            v, state, _, steps, peak = cs.phase_main(
                torch, cs.bubble_kw(256, "float32", visc_coef=1.0e-3),
                cs.STEPS, cs.KERNELS_3D)
        elif key == "cfg5":
            v, state, _, steps, peak, _ = cs.phase_main_ml(
                torch, VardenConfig(**cs.cfg5_kw(256, "float32")),
                cs.STEPS_AMR, cs.KERNELS_AMR, "config 5")
        elif key == "rt":
            v, state, _, steps, peak = cs.phase_main(
                torch, cs.rt_kw(cs.N_RT, "float32"), cs.STEPS,
                cs.KERNELS_RT, bubble=False, **rt_kw)
        elif key == "rtio":
            v, state, steps, peak = rt_inputs(RTIO_STEPS)
        elif key == "2d":
            # the 2-D main cell: the viscous 2-D bubble's geometry at N_2D^2
            v, state, _, steps, peak = cs.phase_main(
                torch, cs.bubble2d_kw(cs.N_2D, "float32",
                                      visc_coef=cs.VISC_2D),
                cs.STEPS, cs.KERNELS_2D)
        elif key == "pub1024":
            v, state, _, steps, peak = cs.phase_main(
                torch, cs.bubble2d_kw(cs.N_2D_PUBLISHED, "float32"),
                cs.STEPS, cs.KERNELS_2D)
        else:
            v, state, _, steps, peak, _ = cs.phase_main_ml(
                torch, VardenConfig(**cs.cfg3_kw("float32")), 6,
                cs.KERNELS_2D, "config 3")
        rec = {"steps_s": [r["seconds"] for r in steps],
               "steady_s": cs.mean_steady(steps),
               "launches": [r["launches"] for r in steps],
               "v_cycles": dict(CYCLES), "peak_bytes": peak}
        for k in ("mac_outer", "hg_outer", "visc_outer", "visc_cycles",
                  "mac_ratio", "hg_ratio", "visc_ratio"):
            if k in steps[-1]:
                rec[k] = [r[k] for r in steps]
        rec["profiled"] = profiled(v, state)
        out[key] = rec
        print(f"  {tag} {key}: steady {rec['steady_s']:.4f} s, idle "
              f"{rec['profiled']['idle_share']:.3f}, V-cycles "
              f"{rec['v_cycles']}", flush=True)
        del v, state
        torch.cuda.empty_cache()
    print(f"RESULT {tag} {json.dumps(out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
