#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (varden_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile FILE]

Phases, each of which asserts and any failure of which exits non-zero:

  1. the card's name and power limit (nvidia-smi), then the build of the
     eleven CUDA kernels from varden_tpu_torch/csrc (one nvcc each, at
     once);
  2. each kernel against its plain PyTorch version on the same inputs at
     the main paths' shapes (256^3 for the five 3-D kernels, 4096^2 for the
     three 2-D ones, BASELINE config 5's patches for kernels 6 and 11 and
     for kernel 2's flux option (the AMR scalar advance's call; in float64
     the 384^3 patch holds kernel 11 alone), and
     128^3 and 256^3 with config 4's boundaries for kernel 7's single
     sweep and its fused V-cycle stages (each beside the ghost pad, padded
     sweeps and restriction they replace), beside kernel 3's sweep and the
     ghost pad at the same shapes, the
     fused V-cycle stages of kernels 3 and 4 at 256^3 and config 5's
     240^3 and 384^3 and kernel 5's at CONST_FUSED_SHAPES, kernel 8's at
     4096^2, 512^2 and 64^2 (GSRB2D_FUSED_SHAPES), each beside the old
     single emits they replace, and kernel 1 at config 5's three level
     shapes), in float32 and again in float64: max abs error of
     each output against the stated tolerance times its own largest
     value, the kernel's time (CUDA events), the plain version's time and
     the bound (bytes or operations, the operations counted by hand from
     each kernel's body);
  3. one advance_timestep of the 3-D bubble at 32^3 in float64 on the card
     against the plain path on the CPU, from one numpy-made state: once
     inviscid, once with visc_coef = diff_coef = 1e-3 (Crank-Nicolson);
  4. the main path, the headline configuration: Varden on the viscous 3-D
     bubble (prob_type 1, 256^3, float32, no-slip walls on all six faces,
     visc_coef 1e-3), initial projection, one pressure iteration and STEPS
     regular steps, with every launch counter set to 0 just before and read
     just after; all five kernels must have launched, kernels 3, 4 and 5
     through their fused V-cycle stages (counted apart);
  5. the main path once more in float64 for STEPS_SHORT steps: the same
     gates, and the float32 run's density extrema and max|u| held against it
     step by step;
  6. the earlier main path at a smaller depth: the inviscid bubble at 256^3
     for STEPS_SHORT steps, the same gates, its four kernels launched;
  7. one advance_timestep of the 2-D bubble at 64^2 in float64 on the card
     against the plain path on the CPU, inviscid and viscous + diffusive;
  8. the 2-D main path: Varden on the published viscous 2-D bubble's
     geometry (walls on four sides, cflfac 0.9) at 4096^2 with nu dt / dx^2
     held at that configuration's 0.59 (see VISC_2D), float32, initial
     projection, one pressure iteration and STEPS steps, the gates of
     phase 4, the three 2-D kernels launched (kernel 9 two launches a
     call, kernel 8 through its fused stages too) and the 3-D ones not;
     then the same path in float64 for
     STEPS_SHORT steps with float32 held to it;
  9. the published 2-D configurations as they are, STEPS steps each with
     the same gates: the inviscid bubble at 64^2 and the viscous one
     (visc_coef 1e-3) at 128^2, the sizes they are published with, and the
     viscous one at 1024^2, where the scheme is still stable with that
     visc_coef (at 2048^2 it no longer is);
 10. multi-level AMR on the card against the plain path on the CPU,
     float64: BASELINE config 5 at a 32^3 base (three levels: 32^3, 48^3,
     64^3), Varden.run for STEPS_SHORT steps, every field of every level;
     then config 5 at a N_AMR_HOLD^3 base on the card in float64 and in
     float32 for STEPS_SHORT steps each, the gates of phase 11, and the
     float32 run's density extrema and max|u| over all levels held to the
     float64 run's step by step;
 11. the AMR main path, BASELINE config 5 as bench.py sets it (3-D bubble,
     256^3 base, max_levs 3, no regrid, visc_coef 1e-3, cflfac 0.5,
     init_shrink 0.5, no pressure iteration, no-slip walls, float32):
     initialization and STEPS_AMR regular steps, every launch counter set
     to 0 just before and read just after; kernels 1-5 must have
     launched (kernel 2 advances the scalars of every level with its flux
     option; kernels 3, 4 and 5 through their fused stages too), kernels
     6 and 11 and the 2-D ones not; the launches of kernels 1-6 and 11
     per steady step are printed; every composite
     solve at or below its
     tolerance, div(umac) falling across the MAC projection, every field
     finite and density in [1, 10] on every level; each composite solve's
     tolerance, roundoff floor and residual on each level are printed;
 12. regrids in the loop: inputs/inputs_3d-regt (64^3, 3 levels, regrid
     every 2 steps) for 4 steps, float32, and BASELINE config 3 (2-D 64^2,
     2 levels, regrid every 4) for 6 steps, each with at least one regrid
     and the gates of phase 11 (config 3: the 2-D kernels, kernel 8
     through its fused stages too);
 13. BASELINE config 4's geometry (3-D Rayleigh-Taylor, periodic in x and
     y, no-slip walls in z) at 32^3 in float64: Varden.run for STEPS_SHORT
     steps on the card against the plain path on the CPU, every field;
 14. the config 4 main path, as bench.py:303-307 sets it (128^3, float32,
     visc_coef 1e-3, cflfac 0.9, four pressure iterations): initialization
     and STEPS steps with the launch counters zeroed before and read
     after; kernels 1-5 and kernel 7 must have launched (kernels 4, 5
     and 7 through their fused stages), the others not; the gates of
     phase 4 except the density range, which varden_tpu itself leaves on
     this problem: the density
     extrema of every step are printed, and the float32 run's extrema and
     max|u| are held to the same path in float64 (STEPS_SHORT steps);
 15. I/O on the card: inputs/inputs_RayleighTaylor_3d as published
     (float64, 32^3 base, 2 levels, regrid every step) to step 20 with a
     checkpoint every 10 steps, its plotfiles and checkpoints read back,
     kernel 7's fused stages launched on this AMR path, and a restart
     from step 10 equal to the uninterrupted run bitwise (every field of every
     patch, and the step-20 plotfile's files byte for byte); then config 4
     at 128^3 in float32 checkpointed at step 2 and restarted, its step-4
     state equal bitwise. The seconds to write and read each kind of file
     are printed;
 16. the decomposed single-level path (varden_tpu_torch.parallel): gloo
     ranks sharing the card, started by parallel.launch, each holding its
     block of every field, its kernels on the card and the halos through
     pinned host buffers (phase_decomposed, on the cells of
     decomp_cells(): 1 step at N_DECOMP_CHECK^3, STEPS_SHORT at the larger
     sizes, cuts of depth). The viscous 3-D bubble and config 4's
     geometry (periodic in x and y: kernel 7's ring sweeps) at
     N_DECOMP_CHECK^3 in float64 on 2 and 4 ranks, and the headline and
     config 2's geometry at N_2D_PUBLISHED^2 on 4 ranks in float64, each
     against its one-rank card run (TOL_DECOMP_F64 of each field's size,
     the same V-cycles a step); then the headline and config 2's
     geometry in float32 on 4 ranks within TOL_DECOMP_F32 of their
     one-rank runs (config 2's
     geometry: or within twice the one-rank float32 run's distance from
     float64 where that is larger, its pressure gradient being float32's
     own roundoff). Every rank records the first call of each kind
     (shapes, emit, boundary codes) of every kernel and holds it against
     the kernel's plain version on the same inputs at TOL_KERNEL, as
     phase 2 does; the gates of phase 4 and the path's kernels launched on
     every rank. It prints, per rank and step, the launches, the halo
     exchanges and their bytes, and the step seconds beside the one-rank
     step: the cost of the decomposition on one card, not a scaling.
 17. AMR under a mesh (phase_decomposed_amr, on the cells of
     amr_decomp_cells()): every patch of every level cut over gloo ranks
     sharing the card, the coarse-fine coupling through parallel.halo's
     fetch and put. Config 5 at an N_AMR_DECOMP^3 base in float64 on 2
     and 4 ranks and at its full 256^3 base in float32 on 4 (1 step),
     config 3 across its regrid and the RT inputs with plotfiles,
     checkpoints and a restart from the mid-run checkpoint on 4, each
     against its one-rank run at the same mesh: the same hierarchy at
     every step, each field of every patch within TOL_DECOMP_F64 (float64,
     with equal V-cycle and outer counts) or TOL_DECOMP_F32 of its size
     (the float32 cell widening as phase 16's 2-D cell does, behind its
     float64 witness, should it fail), every kernel call of every rank
     held to its plain version at TOL_KERNEL, only rank 0 writing, every
     file finite with the one-rank run's boxes and the restart bitwise. It
     prints per rank and step the exchanges and the fetch/put calls,
     elements and seconds.
 18. the tail (phase_tail): profiling.profile_phases on the headline
     (viscous 3-D bubble, 256^3, float32) after its initialization, the
     launch counters zeroed just before and read just after: kernels 1,
     11, 6, 3 and 4 launched (kernel 11 twice a scalar phase call, kernel
     6 once), kernel 2 and the 2-D ones not, the first call of each kind
     of kernels 11 and 6 recorded and held to its plain version at
     TOL_KERNEL, the Timing summary printed; profile_phases on config 2's
     geometry at N_2D^2 (kernels 9, 10 and 8); profile_phases_ml on config
     5 at 256^3 + 2 levels (kernels 1, 3 and 4); each phase TAIL_REPS
     timed calls after one warm-up (a cut of depth: the reference times
     3). Then use_godunov_debug on the card in float64, each run for
     STEPS_SHORT steps against the same run without the flag within
     TOL_STEP of each field's size: the viscous bubble at 32^3 (the
     oracle's edge states, then kernel 6; kernels 1, 2 and 11 not), the
     2-D bubble at 64^2 (kernels 9 and 10 not) and config 5 at a 32^3
     base (kernels 1, 11 and 6 on every level, kernel 2 not). The JSON
     line's launches of kernels 11 and 6 are those of the headline's
     profiled phases, the path that runs them.
 19. the regression suite (phase_regression): the eight quick workloads
     of varden_tpu_torch.regression (run_regression.py's) on the card in
     float64 as shipped, each one's launch counters zeroed just before and
     read just after: its checks pass (advect-3d's fails as it fails in
     varden_tpu's harness, REGRESSION_REFERENCE_FAILS), the kernels of
     REGRESSION_KERNELS launched and kernels 6, 11 and those of the other
     dimension not, the kernel calls of step REGRESSION_RECORD_STEP
     recorded and held to their plain versions at TOL_KERNEL, the checks'
     numbers and the launches a steady step printed (bubble-2d, the
     longest, in a process of its own started beside phase 17); then each
     workload's first REGRESSION_CHECK_STEPS steps on the card against
     the CPU plain path (float64, TOL_STEP, the same boxes; the CPU runs
     in a process of their own while the card runs the quick workloads),
     and the 2-D workloads' in float32 against float64
     (TOL_F32_VS_F64_2D).

Then one JSON line of per-kernel numbers, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}. With --profile FILE,
one more step of each main path runs under torch.profiler: the table of
device time by kernel is written to FILE (3-D), to FILE with "_2d" before
its extension (2-D), with "_amr" (the AMR main path) and with "_rt" (the
config 4 main path), and the host and
device time of each part of the step (the ranges that
advance.advance_timestep and amr.advance_ml.ml_advance record) is
printed. Without a
card, or without the package beside this file, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 rate and the peak rates outside the
# tensor cores, per dtype (dense)
MEM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
# kernel vs plain version, relative to the largest |value| of the plain
# result: the two run the same formulas (nvcc with -fmad=false), but sums
# may be taken in another order, and the operators' outputs are small
# differences of O(1) terms (second differences of smooth fields at
# 256^3 cancel some 50x), so the roundoff of the terms shows up enlarged
TOL_KERNEL = {"float32": 1e-4, "float64": 1e-11}
# whole step, card vs CPU, float64: relative to each field's size; the two
# may take other V-cycle counts, and the MAC and nodal solves stop at
# residuals of rel_eps 1e-10 and 1e-12 of their right-hand sides
TOL_STEP = 1e-8
# density of the bubble lies in [1, densfact] (10 in 3-D, 2 in 2-D): float32 roundoff of
# values up to 10 in the conservative update. With viscosity the scheme
# itself undershoots 1 by 1.4e-5 at 256^3 from the second step on, in
# float64 as in float32 (phase 5 holds the two against each other), so the
# viscous path's bound is wider.
TOL_RHO = 1e-5
TOL_RHO_VISCOUS = 1e-4
# float32 main path against the same path in float64, per step: density
# extrema and max|u| relative to their size; the float32 solvers stop at
# rel_eps 2e-5 of their right-hand sides
TOL_F32_VS_F64 = 1e-4
# the same for the 2-D main path: the flow starts at rest, so max|u| is 0.02
# and 0.04 on the two steps compared, and the float32 projections' stopping
# error (1.5e-6 absolute in max|u|, measured) is 8e-5 of it
TOL_F32_VS_F64_2D = 2e-4
# regular steps of the 256^3 main path, and of its float64 repeat and the
# inviscid path (depth is the only cut), and launches per float32 kernel
# timing (a quarter of that in float64)
STEPS = 4
STEPS_SHORT = 2
REPS = 20
# regular steps of the AMR main path (depth is its only cut)
STEPS_AMR = 3

REPLACES = {
    "velpred_3d_fused": "varden_tpu/ops/pallas_godunov.py:281",
    "mkflux_update_3d_fused": "varden_tpu/ops/pallas_godunov.py:643",
    "gsrb_var_sweep_3d": "varden_tpu/ops/pallas_kernels.py:587",
    "nodal_sweep_3d": "varden_tpu/ops/pallas_kernels.py:892",
    "gsrb_const_sweep_3d": "varden_tpu/ops/pallas_kernels.py:401",
    "gsrb_sweep_2d": "varden_tpu/ops/pallas_kernels.py:210",
    "velpred_2d_fused": "varden_tpu/ops/pallas_godunov.py:909",
    "mkflux_2d_fused": "varden_tpu/ops/pallas_godunov.py:952",
    "update_3d": "varden_tpu/ops/pallas_kernels.py:738",
    "mkflux_3d_fused": "varden_tpu/ops/pallas_godunov.py:402",
    "gsrb_sweep_3d": "varden_tpu/ops/pallas_kernels.py:119",
}
SOURCE = {
    "velpred_3d_fused": "varden_tpu_torch/csrc/velpred.cu",
    "mkflux_update_3d_fused": "varden_tpu_torch/csrc/mkflux_update.cu",
    "gsrb_var_sweep_3d": "varden_tpu_torch/csrc/gsrb_var.cu",
    "nodal_sweep_3d": "varden_tpu_torch/csrc/nodal.cu",
    "gsrb_const_sweep_3d": "varden_tpu_torch/csrc/gsrb_const.cu",
    "gsrb_sweep_2d": "varden_tpu_torch/csrc/gsrb2d.cu",
    "velpred_2d_fused": "varden_tpu_torch/csrc/velpred2d.cu",
    "mkflux_2d_fused": "varden_tpu_torch/csrc/mkflux2d.cu",
    "update_3d": "varden_tpu_torch/csrc/update.cu",
    "mkflux_3d_fused": "varden_tpu_torch/csrc/mkflux.cu",
    "gsrb_sweep_3d": "varden_tpu_torch/csrc/gsrb_padded.cu",
}
# the kernels that each path runs: the viscous 3-D bubble, the inviscid 3-D
# bubble, and every 2-D run (viscous or not: in 2-D the Helmholtz solves
# run on plain tensor code, as in varden_tpu)
KERNELS_3D = ("velpred_3d_fused", "mkflux_update_3d_fused",
              "gsrb_var_sweep_3d", "nodal_sweep_3d", "gsrb_const_sweep_3d")
INVISCID = KERNELS_3D[:4]
KERNELS_2D = ("gsrb_sweep_2d", "velpred_2d_fused", "mkflux_2d_fused")
# the 3-D AMR path runs the single-level kernels (kernel 2 advances the
# scalars with its flux option); the face kernel and the update (kernels 11
# and 6) are off the main paths of phases 4-17: phase 18 (the profiler's
# scalar phase, the debug oracle) runs them; a 2-D AMR run takes the 2-D
# kernels
KERNELS_AMR = KERNELS_3D
OFF_PATH = ("update_3d", "mkflux_3d_fused")
# config 4 (periodic in x): its MAC levels take kernel 7's fused stages (the
# sweeps' ghost rings held at their start); kernel 3 still computes the
# solves' residuals; the RT inputs' AMR run adds the AMR kernels
KERNELS_RT = KERNELS_3D + ("gsrb_sweep_3d",)
KERNELS_RT_AMR = KERNELS_AMR + ("gsrb_sweep_3d",)
# config 4's extent, kernel 7's shapes in phase 2, and the base of
# its card-vs-CPU run; the RT inputs' I/O run ends at step RT_IO_STEPS with
# a checkpoint every RT_IO_CHK steps (cuts of depth: the file runs 150
# steps with a checkpoint every 100)
N_RT = 128
N_RT_PADDED = (128, 256)
N_RT_CHECK = 32
RT_IO_STEPS = 20
RT_IO_CHK = 10
# BASELINE config 5's patch extents at its 256^3 base (the hierarchy that
# initialize_adaptive builds: 256^3, 240^3 at 136, 384^3 at 320)
N_AMR_PATCHES = (256, 240, 384)
# base of the configuration-5 run whose float32 path is held to float64
# (phase 10): 64^3, 80^3 at 24, 112^3 at 72 (2.18 M cells)
N_AMR_HOLD = 64
N_2D = 4096  # 16.8 M cells, the cell count of 256^3
# The viscous 2-D bubble is published at 128^2 with visc_coef 1e-3, where
# nu dt / dx^2 is 0.59 on its first step (dt = cflfac sqrt(2 dx / |g|)). The
# predictor takes the viscous term explicitly, and at 4096^2 the same
# visc_coef makes that number 107: the scheme then blows up within three
# steps, in varden_tpu as in the port (tests/test_torch_run2d.py holds the
# two together at 32^2 with visc_coef 1.4, the same number;
# tests/test_torch_kernels_gpu.py shows it on the card). So the 4096^2 run
# is not the published configuration: it keeps its geometry and scales
# visc_coef by (128/n)^1.5, which holds nu dt / dx^2 at 0.59. The published
# visc_coef itself is driven at 128^2 and at N_2D_PUBLISHED^2 (nu dt / dx^2
# 11 to 15, stable) in phase 9.
VISC_2D = 1.0e-3 * (128.0 / N_2D) ** 1.5
N_2D_PUBLISHED = 1024


class PhaseError(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise PhaseError(msg)


def smi_name_power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


# ---------------------------------------------------------------------------
# inputs, timing, counting
# ---------------------------------------------------------------------------

def smooth(torch, shape, seed, amp, device, dtype, dm=3):
    """A sum of three low sine modes over the last ``dm`` axes per leading
    index; mode numbers and phases from a numpy seed, the field built on the
    device (separable, so no full-size array is made on the host)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lead, sp = tuple(shape[:-dm]), tuple(shape[-dm:])
    out = torch.zeros(tuple(shape), dtype=torch.float64, device=device)
    axes = [torch.linspace(0.0, 1.0, s, dtype=torch.float64, device=device)
            for s in sp]
    for idx in np.ndindex(*lead):
        f = torch.zeros(sp, dtype=torch.float64, device=device)
        for _ in range(3):
            k, ph = rng.randint(1, 4, size=dm), rng.rand(dm) * 2 * math.pi
            w = [torch.sin(float(k[d]) * math.pi * axes[d] + float(ph[d]))
                 for d in range(dm)]
            mode = w[0]
            for wd in w[1:]:
                mode = mode[..., None] * wd
            f += mode
        out[idx] = amp * f / 3.0
    return out.to(dtype)


def cuda_ms(torch, fn, reps):
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


# Operations of each kernel's function per interior cell (or node),
# counted by hand from the kernel bodies in varden_tpu_torch/csrc: every
# add, sub, mul, div, min, max, abs, compare and select counts one; each
# intermediate value (a slope, a face state, a node difference) counts once
# where it is made, though the staged kernels make some of them again; work
# done only on boundary faces is left out. So the count is a floor for the
# function. The peak rates above count an FMA as two operations, while the
# kernels are built with -fmad=false: the operations bound is the least
# time of any implementation, not of this one.
SLOPE_OPS = {0: 0, 2: 18, 4: 28}  # Fromm slope 18, fourth-order step 10
RIEMANN_NORMAL, RIEMANN_TRANSVERSE = 9, 7
NODAL_EMIT_OPS = {"apply": 0, "residual": 1, "jacobi": 4}


def velpred_ops(order):
    """max|u| (6); 9 slopes; per axis the hat states (two fractions 8,
    l/r of 3 components 12, one normal and two transverse solves); 6
    double-hat states (correction 4, l/r minus it 2, transverse solve);
    per face set the full state (two corrections 9, l/r minus them 2,
    force 3, normal solve)."""
    hat = 8 + 12 + RIEMANN_NORMAL + 2 * RIEMANN_TRANSVERSE
    return (6 + 9 * SLOPE_OPS[order] + 3 * hat
            + 6 * (4 + 2 + RIEMANN_TRANSVERSE)
            + 3 * (9 + 2 + 3 + RIEMANN_NORMAL))


def mkflux_update_ops(cons, force, fupd, order):
    """max|mac| (6); per component (cons[c]: conservative) 3 slopes, 3 hat
    states (l/r 10, transverse solve), 6 double-hat states (correction 3
    conservative or 4 convective, l/r minus it 2, transverse solve), 3 edge
    states (two corrections 15 or 9, l/r minus them 2, force 3, transverse
    solve) and the update (flux divergence 11 or u.grad s 17, dt and
    subtract 2, fupd 2)."""
    ops = 6
    for c in cons:
        ops += (3 * SLOPE_OPS[order] + 3 * (10 + RIEMANN_TRANSVERSE)
                + 6 * ((3 if c else 4) + 2 + RIEMANN_TRANSVERSE)
                + 3 * ((15 if c else 9) + 2 + (3 if force else 0)
                       + RIEMANN_TRANSVERSE)
                + (11 if c else 17) + 2 + (2 if fupd else 0))
    return ops


# L(phi) with alpha = 0: per axis two differences, two beta products, a
# subtract and the 1/dx^2 scale (6), two adds and the sign (21), rhs - L
# (22); the sweep adds * inv_diag and + phi; the restriction |r| and max per
# fine cell and 7 adds and 7 halvings per coarse cell
GSRB_OPS = {"sweep": 24, "residual": 22, "restrict": 24 + 14 / 8}


def gsrb_fused_ops(case, nsweeps):
    """Kernel 3's fused stages per fine cell: the sweeps, then the residual
    with |r| and max and the restriction (7 adds and 7 halvings per coarse
    cell) (smooth_restrict); or the prolongation's add, then the sweeps
    (smooth+corr)."""
    sweeps = nsweeps * GSRB_OPS["sweep"]
    if case == "smooth_restrict":
        return sweeps + GSRB_OPS["restrict"]
    return 1 + sweeps


def const_fused_ops(case, nsweeps):
    """Kernel 5's fused stages per cell and field: the sweeps (the alpha
    term in), then the residual with |r| and max and the restriction (7
    adds and 7 halvings per coarse cell) (smooth_restrict); or the
    prolongation's add, then the sweeps (smooth+corr)."""
    sweeps = nsweeps * gsrb_const_ops("sweep", True)
    if case == "smooth_restrict":
        return sweeps + gsrb_const_ops("residual", True) + 2 + 14 / 8
    return 1 + sweeps


def gsrb_const_ops(emit, use_alpha, have_rhs=True):
    """Constant-coefficient L(phi) per cell and field: per axis the two
    neighbours' sum, 2 phi, a subtract and the coefficient (4; 2 phi counted
    once), two adds and the sign (15); the alpha term 3; rhs - L 1; the
    sweep adds * inv_diag and + phi."""
    return (15 + (3 if use_alpha else 0) + (1 if have_rhs else 0)
            + (2 if emit == "sweep" else 0))


def nodal_ops(emit):
    """Per node and axis: one node difference, the 2x2 tangential mass
    weighting (16), sigma times the scale and the four products (5), the
    transpose difference into eight nodes (8); then the emit."""
    return 3 * (1 + 16 + 5 + 8) + NODAL_EMIT_OPS[emit]


def nodal_fused_ops(case, nsweeps):
    """Kernel 4's fused stages per fine node: the sweeps and
    (smooth_restrict) the residual with |r| and max and 39/8 of the
    restriction (13 weighted sums of three per coarse node), or
    (smooth+corr) the prolongation (3 sums of two, 3 halvings) and its add,
    then the sweeps."""
    sweeps = nsweeps * nodal_ops("jacobi")
    if case == "smooth_restrict":
        return sweeps + nodal_ops("residual") + 2 + 39 / 8
    return 7 + sweeps


def velpred2d_ops(order):
    """max|u| (4); 4 slopes; per axis the hat states (two fractions 8, l/r
    of 2 components 8, one normal and one transverse solve); per face set
    the full state (the correction 4, l/r minus it 2, force 4, normal
    solve)."""
    hat = 8 + 8 + RIEMANN_NORMAL + RIEMANN_TRANSVERSE
    return 4 + 4 * SLOPE_OPS[order] + 2 * hat + 2 * (4 + 2 + 4 + RIEMANN_NORMAL)


def mkflux2d_ops(cons, force, order):
    """max|mac| (4); per component (cons[c]: conservative) 2 slopes, 2 hat
    states (l/r 10, transverse solve) and 2 edge states (the correction 8
    conservative or 4 convective, l/r minus it 2, force 4, transverse
    solve, the flux 1)."""
    ops = 4
    for c in cons:
        ops += (2 * SLOPE_OPS[order] + 2 * (10 + RIEMANN_TRANSVERSE)
                + 2 * ((8 if c else 4) + 2 + (4 if force else 0)
                       + RIEMANN_TRANSVERSE + (1 if c else 0)))
    return ops


def gsrb2d_ops(emit, use_alpha):
    """L(phi) per cell: per axis two differences, two beta products, a
    subtract and the 1/dx^2 scale (6), one add and the sign (14); the alpha
    term 3; rhs - L 1; the sweep adds * inv_diag and + phi."""
    return 15 + (3 if use_alpha else 0) + (2 if emit == "sweep" else 0)


def gsrb2d_fused_ops(case, nsweeps):
    """Kernel 8's fused stages per fine cell: the sweeps, then the residual
    with |r| and max and the restriction (3 adds and 3 halvings per coarse
    cell) (smooth_restrict); or the prolongation's add, then the sweeps
    (smooth+corr)."""
    sweeps = nsweeps * gsrb2d_ops("sweep", False)
    if case == "smooth_restrict":
        return sweeps + gsrb2d_ops("residual", False) + 2 + 6 / 4
    return 1 + sweeps


def update_ops(cons, force):
    """Per cell and component (cons[c]: conservative): three face
    differences and divisions and two adds (8), or three MAC averages (two
    each), face differences, products and divisions and two adds (17); the
    dt product and subtract (2); the force 2."""
    return sum((8 if c else 17) + 2 + (2 if force else 0) for c in cons)


def mkflux_ops(cons, force, order):
    """mkflux_update_ops without the update: max|mac| (6); per component 3
    slopes, 3 hat states, 6 double-hat states, 3 edge states, and the flux
    product of a conservative component on each face set (3)."""
    ops = 6
    for c in cons:
        ops += (3 * SLOPE_OPS[order] + 3 * (10 + RIEMANN_TRANSVERSE)
                + 6 * ((3 if c else 4) + 2 + RIEMANN_TRANSVERSE)
                + 3 * ((15 if c else 9) + 2 + (3 if force else 0)
                       + RIEMANN_TRANSVERSE) + (3 if c else 0))
    return ops


def nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bytes_moved, ops, dtype_name):
    t_bytes = bytes_moved / MEM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_errs(out, ref):
    """[(max |out - ref|, max |ref|)] for each output tensor, nested tuples
    flattened: the outputs of a tuple (a fused stage's phi, coarse residual
    and max|r|; a face set's three components) are each held on their own
    scale."""
    if not isinstance(out, (tuple, list)):
        return [((out.double() - ref.double()).abs().max().item(),
                 ref.double().abs().max().item())]
    need(isinstance(ref, (tuple, list)) and len(out) == len(ref),
         "the kernel's outputs do not match its plain version's in number")
    return [e for o, r in zip(out, ref) for e in max_errs(o, r)]


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def kernel_cases(torch, dtype_name, n=256):
    """(kernel, case, wrapper call, plain call, bytes, operations) at the
    main path's 256^3 shapes: the wall-bounded bubble's Sim, smooth seeded
    fields."""
    from varden_tpu_torch import advance, problems, projection
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.ops import cuda_godunov as cg
    from varden_tpu_torch.ops import cuda_kernels as ck
    from varden_tpu_torch.solvers import mg, nodal
    from varden_tpu_torch.state import Sim

    cfg = VardenConfig(**bubble_kw(n, dtype_name))
    sim = Sim(cfg, device="cuda")
    dev, dt_ = sim.device, sim.dtype
    N, ng = sim.n_cell, sim.ng
    cells, order = math.prod(N), cfg.slope_order
    dt = 0.5 * sim.dx[0] / 0.5
    cases = []

    # kernel 1: velpred on u, force with ng ghosts
    u = smooth(torch, (3,) + N, 1, 0.5, dev, dt_)
    f = smooth(torch, (3,) + N, 2, 0.3, dev, dt_)
    u_pad, f_pad = sim.fill_vel(u), sim.fill_extrap(f, ng)
    adv_v = [sim.adv_bc[d] for d in range(3)]
    a1 = (u_pad, f_pad, dt, sim.dx, sim.phys_bc, adv_v, ng, N,
          cfg.slope_order, cfg.use_minion)
    outs = cg.velpred_3d_plain(*a1)
    cases.append(("velpred_3d_fused", "velocity", lambda: cg.velpred_3d_fused(*a1),
                  lambda: cg.velpred_3d_plain(*a1),
                  nbytes([u_pad, f_pad, *outs]), velpred_ops(order) * cells))

    # kernel 2: scalars (conservative density + tracer, no forces) and
    # velocity (convective, with both forces), on the predicted faces
    mac_pads = advance.embed_faces(sim, outs, ng)
    st = problems.initdata(sim)
    s_pad = sim.fill_scal(st.s + smooth(torch, (2,) + N, 3, 0.05, dev, dt_))
    adv_s = [sim.adv_bc[sim.scal_comp(i)] for i in range(2)]
    a2 = (s_pad, mac_pads, None, None, None, dt, sim.dx, sim.phys_bc, adv_s,
          ng, N, False, [True, False], cfg.slope_order, cfg.use_minion)
    fupd = smooth(torch, (3,) + N, 4, 0.2, dev, dt_)
    a3 = (u_pad, mac_pads, f_pad, fupd, None, dt, sim.dx, sim.phys_bc, adv_v,
          ng, N, True, [False] * 3, cfg.slope_order, cfg.use_minion)
    # the diffusive step's scalars: a tracer force on the edge states and
    # at the update (density's is zero), advance.advance_timestep's shapes
    sf = smooth(torch, (2,) + N, 9, 0.1, dev, dt_)
    sf[0] = 0.0
    sf_pad, sfupd = sim.fill_extrap(sf, ng), 0.5 * sf
    a4 = (s_pad, mac_pads, sf_pad, sfupd, *a2[4:])
    for case, a, ins in (("scalars", a2, [s_pad, *mac_pads]),
                         ("scal+force", a4, [s_pad, *mac_pads, sf_pad, sfupd]),
                         ("velocity", a3, [u_pad, *mac_pads, f_pad, fupd])):
        nc = a[0].shape[0]
        out_b = nc * cells * a[0].element_size()
        ops = mkflux_update_ops(a[12], a[2] is not None, a[3] is not None,
                                order) * cells
        cases.append(("mkflux_update_3d_fused", case,
                      (lambda a=a: cg.mkflux_update_3d_fused(*a)),
                      (lambda a=a: cg.mkflux_update_3d_plain(*a)),
                      nbytes(ins) + out_b, ops))

    # kernel 3: the MAC operator of the bubble's density, Neumann walls
    rho = st.s[0]
    beta = projection.mk_mac_coeffs(sim, rho)
    ell_bc = [tuple(sim.ell_bc[sim.press_comp][d]) for d in range(3)]
    lev = mg.make_level(N, sim.dx, ell_bc, sim.zeros(N), beta, 0.0)
    phi = smooth(torch, N, 5, 0.5, dev, dt_)
    rhs = smooth(torch, N, 6, 50.0, dev, dt_)
    bv = [[0.0, 0.0]] * 3
    cell = phi.element_size() * cells
    for emit, b in (("sweep", cell * 4 + nbytes(beta)),
                    ("residual", cell * 3 + nbytes(beta)),
                    ("restrict", cell * 2 + cell // 8 + nbytes(beta))):
        g = (phi, rhs, lev.inv_diag, lev.beta, lev.dx, ell_bc, bv)
        cases.append(("gsrb_var_sweep_3d", emit,
                      (lambda g=g, e=emit: ck.gsrb_var_sweep_3d(*g, emit=e)),
                      (lambda g=g, e=emit: ck.gsrb_var_sweep_3d_plain(*g, emit=e)),
                      b, GSRB_OPS[emit] * cells))

    # kernel 5: the viscous operator rho - mu lap of the headline bubble
    # (no-slip walls: Dirichlet on every face, one operator for the three
    # components) at visc_solve's, lap_velocity's and diff_scalar_solve's
    # shapes; and a smaller grid with periodic x and non-zero Dirichlet values
    mu = 0.5 * dt * 1.0e-3
    u3 = smooth(torch, (3,) + N, 10, 0.5, dev, dt_)
    r3 = smooth(torch, (3,) + N, 11, 2.0, dev, dt_)
    ones = torch.ones(N, dtype=dt_, device=dev)

    def const_case(case, n_, ell, bvs, p, r, aco, emit):
        lv = mg.make_level(n_, sim.dx, ell, ones if aco is None else aco,
                           (mu,) * 3, 0.0 if aco is None else 1.0)
        coef = ([1.0 / h ** 2 for h in sim.dx] + [0.0] if r is None else
                [mu / h ** 2 for h in sim.dx] + [1.0])
        inv = lv.inv_diag if emit == "sweep" else None
        g = (p, r, inv, coef, ell, bvs)
        moved = nbytes([p, r, inv, aco]) + nbytes([p])
        ops = gsrb_const_ops(emit, aco is not None, r is not None) * p.numel()
        cases.append(("gsrb_const_sweep_3d", case,
                      (lambda: ck.gsrb_const_sweep_3d(*g, aco=aco, emit=emit)),
                      (lambda: ck.gsrb_const_sweep_3d_plain(*g, aco=aco,
                                                            emit=emit)),
                      moved, ops))

    ell_v, bv_v = projection.comp_bc(sim, 0)
    const_case("sweep B3", N, ell_v, bv_v, u3, r3, rho, "sweep")
    const_case("resid B3", N, ell_v, bv_v, u3, r3, rho, "residual")
    const_case("lap B3", N, ell_v, bv_v, u3, None, None, "residual")
    ell_t, bv_t = projection.comp_bc(sim, sim.scal_comp(1))
    const_case("sweep B1", N, ell_t, bv_t, u3[:1], r3[:1], ones, "sweep")
    ns_ = (n // 4,) * 3
    sm = [slice(0, s) for s in ns_]
    const_case("per-x dir", ns_, [(0, 0), (2, 2), (1, 2)],
               [[0.0, 0.0], [0.3, -0.2], [0.0, 0.5]],
               u3[(slice(None), *sm)].contiguous(),
               r3[(slice(None), *sm)].contiguous(),
               rho[tuple(sm)].contiguous(), "sweep")

    # kernel 4: the nodal operator of sigma = 1/rho, walls (no mask)
    pmask = sim.pmask
    ns = nodal.node_shape(N, pmask)
    sigma = 1.0 / rho
    phin = smooth(torch, ns, 7, 0.5, dev, dt_)
    rhsn = smooth(torch, ns, 8, 1e-4, dev, dt_)
    inv = 1.0 / nodal.node_diag(sigma, sim.dx, pmask, 3)
    phi_pad = ck.node_pad(phin, pmask, 3)
    sig_np = ck.node_sigma_np(sigma, pmask, 3)
    node = phin.element_size() * math.prod(ns)
    for emit, b in (("jacobi", nbytes([phi_pad, sig_np]) + 3 * node),
                    ("residual", nbytes([phi_pad, sig_np]) + 2 * node),
                    ("apply", nbytes([phi_pad, sig_np]) + node)):
        a = (phi_pad, sig_np, rhsn, inv, sim.dx)
        cases.append(("nodal_sweep_3d", emit,
                      (lambda a=a, e=emit: ck.nodal_sweep_3d(*a, emit=e)),
                      (lambda a=a, e=emit: ck.nodal_sweep_3d_plain(*a, emit=e)),
                      b, nodal_ops(emit) * math.prod(ns)))
    return cases


def kernel_cases_2d(torch, dtype_name, n=N_2D):
    """The same for the three 2-D kernels at the 2-D main path's 4096^2
    shapes: the wall-bounded viscous bubble's Sim, smooth seeded fields;
    beside it an inlet/outlet Sim for the Godunov kernels, and for the
    sweep a periodic-x grid with non-zero Dirichlet values and an alpha
    term, and a grid of odd extents."""
    from varden_tpu_torch import advance, problems, projection
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.ops import cuda_godunov as cg
    from varden_tpu_torch.ops import cuda_kernels as ck
    from varden_tpu_torch.solvers import mg
    from varden_tpu_torch.state import Sim

    walls = Sim(VardenConfig(**bubble2d_kw(n, dtype_name)), device="cuda")
    flow = Sim(VardenConfig(**bubble2d_kw(
        n, dtype_name, bcx_lo=11, bcx_hi=12, bcy_lo=14, bcy_hi=14,
        u_bc=((0.7, 0.0), (0.0, 0.0), (0.0, 0.0)),
        rho_bc=((1.3, 0.0), (0.0, 0.0), (0.0, 0.0)))), device="cuda")
    dev, dt_ = walls.device, walls.dtype
    N, ng, order = walls.n_cell, walls.ng, walls.cfg.slope_order
    cells = math.prod(N)
    dt = 0.9 * walls.dx[0] / 0.5
    cases = []

    def sm(shape, seed, amp):
        return smooth(torch, shape, seed, amp, dev, dt_, dm=2)

    u, f = sm((2,) + N, 21, 0.5), sm((2,) + N, 22, 0.3)
    s0 = problems.initdata(walls).s + sm((2,) + N, 23, 0.05)
    sf = sm((2,) + N, 24, 0.1)
    sf[0] = 0.0
    rho = s0[0].contiguous()
    for case, sim in (("walls", walls), ("inlet/outlet", flow)):
        cfg = sim.cfg
        # kernel 9: velpred on u, force with ng ghosts
        u_pad, f_pad = sim.fill_vel(u), sim.fill_extrap(f, ng)
        adv_v = [sim.adv_bc[d] for d in range(2)]
        a1 = (u_pad, f_pad, dt, sim.dx, sim.phys_bc, adv_v, ng, N,
              cfg.slope_order, cfg.use_minion)
        outs = cg.velpred_2d_plain(*a1)
        cases.append(("velpred_2d_fused", case,
                      (lambda a=a1: cg.velpred_2d_fused(*a)),
                      (lambda a=a1: cg.velpred_2d_plain(*a)),
                      nbytes([u_pad, f_pad, *outs]),
                      velpred2d_ops(order) * cells))
        # kernel 10 on the predicted faces: the scalars (conservative
        # density + tracer) without forces as the viscous step passes them
        # and with the diffusive step's tracer force, and the velocity
        # (convective, with its force)
        mac_pads = advance.embed_faces(sim, outs, ng)
        s_pad = sim.fill_scal(s0)
        adv_s = [sim.adv_bc[sim.scal_comp(i)] for i in range(2)]
        tail = (dt, sim.dx, sim.phys_bc)
        opts = (cfg.slope_order, cfg.use_minion)
        variants = [
            ("scalars", (s_pad, *mac_pads, None, None, *tail, adv_s, ng, N,
                         False, [True, False], *opts)),
            ("velocity", (u_pad, *mac_pads, f_pad, None, *tail, adv_v, ng, N,
                          True, [False, False], *opts))]
        if sim is walls:
            variants.insert(1, ("scal+force", (
                s_pad, *mac_pads, sim.fill_extrap(sf, ng), None, *tail,
                adv_s, ng, N, False, [True, False], *opts)))
        for vname, a in variants:
            face = a[0].element_size() * 2 * (cells + N[0])
            cases.append(("mkflux_2d_fused",
                          vname if sim is walls else f"{vname} {case}",
                          (lambda a=a: cg.mkflux_2d_fused(*a)),
                          (lambda a=a: cg.mkflux_2d_plain(*a)),
                          nbytes(a[:4]) + 4 * face,
                          mkflux2d_ops(a[12], a[3] is not None, order) * cells))

    # kernel 8: the MAC operator of the bubble's density, Neumann walls
    beta = projection.mk_mac_coeffs(walls, rho)
    ell_bc = [tuple(walls.ell_bc[walls.press_comp][d]) for d in range(2)]
    phi, rhs = sm(N, 25, 0.5), sm(N, 26, 50.0)

    def gsrb_case(case, n_, ell, bvs, alpha, emit):
        sl = tuple(slice(0, e) for e in n_)
        cut = [t[tuple(slice(0, e + (1 if d == a else 0))
                       for d, e in enumerate(n_))].contiguous()
               for a, t in enumerate(beta)]
        aco = rho[sl].contiguous() if alpha else None
        lv = mg.make_level(n_, walls.dx, ell,
                           aco if alpha else walls.zeros(n_), cut, alpha)
        inv = lv.inv_diag if emit == "sweep" else None
        g = (phi[sl].contiguous(), rhs[sl].contiguous(), inv, lv.beta,
             lv.dx, ell, bvs)
        kw = dict(aco=aco, alpha=alpha, emit=emit)
        cases.append(("gsrb_sweep_2d", case,
                      (lambda: ck.gsrb_sweep_2d(*g, **kw)),
                      (lambda: ck.gsrb_sweep_2d_plain(*g, **kw)),
                      nbytes([g[0], g[1], inv, aco, *lv.beta]) + nbytes(g[:1]),
                      gsrb2d_ops(emit, bool(alpha)) * math.prod(n_)))

    zero_bv = [[0.0, 0.0]] * 2
    gsrb_case("sweep", N, ell_bc, zero_bv, 0.0, "sweep")
    gsrb_case("residual", N, ell_bc, zero_bv, 0.0, "residual")
    gsrb_case("per-x dir", (n // 2, n // 4), [(0, 0), (2, 2)],
              [[0.0, 0.0], [0.3, -0.2]], 1.0, "sweep")
    gsrb_case("odd", (n // 4 - 1, n // 2 + 1), [(1, 2), (2, 1)],
              [[0.0, 0.5], [-0.4, 0.0]], 0.0, "sweep")
    gsrb_case("odd resid", (n // 4 - 1, n // 2 + 1), [(1, 2), (2, 1)],
              [[0.0, 0.5], [-0.4, 0.0]], 0.0, "residual")
    return cases


# the largest patch (cells) at which phase 2 holds every AMR kernel in
# float64; above it kernel 11 alone (its plain version peaks at 43.8 GB of
# device memory at 384^3 in float64; kernels 2's and 6's plain versions
# were not run at that size)
F64_ALL_KERNELS_MAX = 240 ** 3


def kernel_cases_amr(torch, dtype_name, shapes=None):
    """Kernels 6 and 11, and kernel 2 with its flux option (the AMR scalar
    advance's call; the bound counts the flux bytes and the flux products),
    at the AMR main path's shapes: BASELINE config 5's
    patches (256^3 with its walls; 240^3 and 384^3, interior patches whose
    every side is coarse-fine) and an odd, thin grid (or ``shapes``):
    smooth seeded fields on seeded MAC faces. In float64 the 384^3 patch
    holds kernel 11 alone (F64_ALL_KERNELS_MAX). A generator: one shape's
    inputs live at a time."""
    from varden_tpu_torch import advance, problems
    from varden_tpu_torch.config import INTERIOR, VardenConfig
    from varden_tpu_torch.ops import cuda_godunov as cg
    from varden_tpu_torch.ops import cuda_update as cu
    from varden_tpu_torch.state import Sim

    if shapes is None:
        shapes = [(n,) * 3 for n in N_AMR_PATCHES] + [(37, 5, 61)]
    for n in shapes:
        sim = Sim(VardenConfig(**cfg5_kw(n[0], dtype_name, n_celly=n[1],
                                         n_cellz=n[2])), device="cuda")
        dev, dt_, ng, order = sim.device, sim.dtype, sim.ng, \
            sim.cfg.slope_order
        cells = math.prod(n)
        # a cfg5 fine patch has coarse-fine ghosts on every side
        pbc = (sim.phys_bc if n[0] == N_AMR_PATCHES[0] or n[0] == 37
               else ((INTERIOR, INTERIOR),) * 3)
        tag = f"{n[0]}x{n[1]}x{n[2]}"
        dt = 0.5 * sim.dx[0] / 0.5
        faces = [tuple(n[t] + (1 if t == d else 0) for t in range(3))
                 for d in range(3)]
        umac = tuple(smooth(torch, faces[d], 40 + d, 0.5, dev, dt_)
                     for d in range(3))
        mac_pads = advance.embed_faces(sim, umac, ng)
        s_pad = sim.fill_scal(problems.initdata(sim).s
                              + smooth(torch, (2,) + n, 43, 0.05, dev, dt_))
        sf = smooth(torch, (2,) + n, 44, 0.1, dev, dt_)
        sf[0] = 0.0
        sf_pad = sim.fill_extrap(sf, ng)
        del sf
        u_pad = sim.fill_vel(smooth(torch, (3,) + n, 45, 0.5, dev, dt_))
        uf_pad = sim.fill_extrap(smooth(torch, (3,) + n, 46, 0.3, dev, dt_),
                                 ng)
        adv_s = [sim.adv_bc[sim.scal_comp(i)] for i in range(2)]
        adv_v = [sim.adv_bc[d] for d in range(3)]
        tail = (dt, sim.dx, pbc)
        for case, a in (
                ("scalars", (s_pad, mac_pads, None, None, *tail, adv_s, ng,
                             n, False, [True, False], order, False)),
                ("scal+force", (s_pad, mac_pads, sf_pad, None, *tail, adv_s,
                                ng, n, False, [True, False], order, False)),
                ("velocity", (u_pad, mac_pads, uf_pad, None, *tail, adv_v,
                              ng, n, True, [False] * 3, order, False))):
            nc = a[0].shape[0]
            face_b = sum(math.prod(f) for f in faces) * nc * \
                a[0].element_size()
            yield ("mkflux_3d_fused", f"{case} {tag}",
                   (lambda a=a: cg.mkflux_3d_fused(*a)),
                   (lambda a=a: cg.mkflux_3d_plain(*a)),
                   nbytes([a[0], *a[1], a[2]]) + 2 * face_b,
                   mkflux_ops(a[11], a[2] is not None, order) * cells)
        if dtype_name == "float64" and cells > F64_ALL_KERNELS_MAX:
            del a, s_pad, sf_pad, u_pad, uf_pad, mac_pads, umac
            continue
        # kernel 2 with its flux option, as the AMR scalar advance calls it:
        # density conservative with its flux, a tracer convective, no force
        a = (s_pad, mac_pads, None, None, None, *tail, adv_s, ng, n, False,
             [True, False], order, False)
        flux_b = sum(math.prod(f) for f in faces) * s_pad.element_size()
        yield ("mkflux_update_3d_fused", f"scalars+flux {tag}",
               (lambda a=a: cg.mkflux_update_3d_fused(*a, flux_comps=(0,))),
               (lambda a=a: cg.mkflux_update_3d_plain(*a, flux_comps=(0,))),
               nbytes([s_pad, *mac_pads]) + 2 * cells * s_pad.element_size()
               + flux_b,
               (mkflux_update_ops([True, False], False, False, order) + 3)
               * cells)
        del s_pad, sf_pad, u_pad, uf_pad, mac_pads
        # kernel 6: the scalars' update (density conservative, a tracer
        # convective; no force, as the inviscid scalar step passes it) and
        # three convective components with a force
        for case, cons, with_f in (("nc2 [T,F]", [True, False], False),
                                   ("nc3 conv+force", [False] * 3, True)):
            nc = len(cons)
            sold = smooth(torch, (nc,) + n, 47, 1.0, dev, dt_) + 1.5
            force = (smooth(torch, (nc,) + n, 48, 0.2, dev, dt_) if with_f
                     else None)
            per_c = [smooth(torch, (nc,) + f, 49 + d, 1.0, dev, dt_)
                     for d, f in enumerate(faces)]
            sedge = None if all(cons) else per_c
            flux = None if not any(cons) else per_c
            a = (sold, umac, sedge, flux, force, dt, sim.dx, cons)
            read = nbytes([sold, force, *umac]) + sum(
                math.prod(f) for f in faces) * nc * sold.element_size()
            yield ("update_3d", f"{case} {tag}",
                   (lambda a=a: cu.update_3d(*a)),
                   (lambda a=a: cu.update_3d_plain(*a)),
                   read + nbytes([sold]), update_ops(cons, with_f) * cells)
            del a, sold, force, per_c, sedge, flux
        del umac


def smoother_cases(torch, dtype_name, n):
    """Kernels 3 and 4's fused stages (ck.FUSED_SWEEPS sweeps, as the
    V-cycles call them) at n^3: the MAC operator of a seeded density in
    [1, 10] with Neumann walls at the 256^3 base and the coarse-fine ghost
    code (3) on every side of config 5's patches, the nodal operator of
    sigma = 1/rho with walls; each beside the old single emits that a
    V-cycle's level visit called instead (two-launch sweeps and the
    restriction; the plain prolongation and the sweeps; the nodal pads,
    Jacobi passes, residual, plain restriction and prolongation)."""
    from varden_tpu_torch.ops import cuda_kernels as ck
    from varden_tpu_torch.solvers import mg, nodal
    nsw = ck.FUSED_SWEEPS
    dev, dt_ = torch.device("cuda"), getattr(torch, dtype_name)
    N = (n,) * 3
    dx = (1.0 / n,) * 3
    cells = n ** 3
    code = 1 if n == N_AMR_PATCHES[0] else 3
    ell = [(code, code)] * 3
    rho = 5.5 + 4.5 * smooth(torch, N, 60, 1.0, dev, dt_)
    beta = []
    for d in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[d], hi[d] = slice(0, 1), slice(n - 1, n)
        q = torch.cat([rho[tuple(lo)], rho, rho[tuple(hi)]], dim=d)
        a = q.narrow(d, 0, n + 1)
        b = q.narrow(d, 1, n + 1)
        beta.append((2.0 / (a + b)).contiguous())
    lev = mg.make_level(N, dx, ell, torch.zeros(N, dtype=dt_, device=dev),
                        tuple(beta), 0.0)
    phi = smooth(torch, N, 61, 0.5, dev, dt_)
    rhs = smooth(torch, N, 62, 50.0, dev, dt_)
    corr = smooth(torch, (n // 2,) * 3, 63, 0.1, dev, dt_)
    bv = [[0.0, 0.0]] * 3
    g = (phi, rhs, lev.inv_diag, lev.beta, lev.dx, ell, bv)
    fb = 4 * nbytes([phi]) + nbytes(beta)  # phi, rhs, inv_diag in, phi out
    tag = f"{n}^3"

    def sweeps(p):
        for _ in range(nsw):
            p = ck.gsrb_var_sweep_3d(p, *g[1:])
        return p

    cases = [
        ("gsrb_var_sweep_3d", f"smooth_restrict {tag}",
         (lambda: ck.gsrb_var_sweep_3d(*g, emit="smooth_restrict",
                                       nsweeps=nsw)),
         (lambda: ck.gsrb_var_sweep_3d_plain(*g, emit="smooth_restrict",
                                             nsweeps=nsw)),
         fb + nbytes([phi]) // 8,
         gsrb_fused_ops("smooth_restrict", nsw) * cells,
         (lambda: ck.gsrb_var_sweep_3d(sweeps(phi), *g[1:],
                                       emit="restrict"))),
        ("gsrb_var_sweep_3d", f"smooth+corr {tag}",
         (lambda: ck.gsrb_var_sweep_3d(*g, emit="smooth",
                                       nsweeps=nsw, corr=corr)),
         (lambda: ck.gsrb_var_sweep_3d_plain(*g, emit="smooth",
                                             nsweeps=nsw, corr=corr)),
         fb + nbytes([corr]), gsrb_fused_ops("smooth+corr", nsw) * cells,
         (lambda: sweeps(phi + ck.cell_prolong(corr, (2, 2, 2))))),
    ]
    del rho
    pmask = (False,) * 3
    ns = nodal.node_shape(N, pmask)
    sigma = 1.0 / (5.5 + 4.5 * smooth(torch, N, 64, 1.0, dev, dt_))
    phin = smooth(torch, ns, 65, 0.5, dev, dt_)
    rhsn = smooth(torch, ns, 66, 1e-4, dev, dt_)
    cn = tuple(s // 2 + 1 for s in N)
    corrn = smooth(torch, cn, 67, 0.1, dev, dt_)
    inv = 1.0 / nodal.node_diag(sigma, dx, pmask, 3)
    a = (phin, sigma, rhsn, inv, dx, nodal.JACOBI_OMEGA)
    nodes = math.prod(ns)
    node = phin.element_size() * nodes

    def jac(p, sig_np):
        for _ in range(nsw):
            p = ck.nodal_sweep_3d(ck.node_pad(p, pmask, 3), sig_np, rhsn,
                                  inv, dx, nodal.JACOBI_OMEGA, "jacobi")
        return p

    def old_restrict():
        sig_np = ck.node_sigma_np(sigma, pmask, 3)
        p = jac(phin, sig_np)
        r = ck.nodal_sweep_3d(ck.node_pad(p, pmask, 3),
                              ck.node_sigma_np(sigma, pmask, 3), rhsn,
                              None, dx, emit="residual")
        return p, ck.node_restrict(r, pmask, 3), r.abs().max()

    def old_corr():
        sig_np = ck.node_sigma_np(sigma, pmask, 3)
        p = phin + ck.node_prolong(corrn, ns, pmask, 3)
        return jac(p, sig_np)

    nb = 4 * node + nbytes([sigma])  # phi, rhs, inv_diag in, phi out
    cases += [
        ("nodal_sweep_3d", f"smooth_restrict {tag}",
         (lambda: ck.nodal_sweep_3d(*a, "smooth_restrict", pmask=pmask,
                                    nsweeps=nsw)),
         (lambda: ck.nodal_sweep_3d_plain(*a, "smooth_restrict", pmask=pmask,
                                          nsweeps=nsw)),
         nb + node // 8, nodal_fused_ops("smooth_restrict", nsw) * nodes,
         old_restrict),
        ("nodal_sweep_3d", f"smooth+corr {tag}",
         (lambda: ck.nodal_sweep_3d(*a, "smooth", pmask=pmask,
                                    nsweeps=nsw, corr=corrn)),
         (lambda: ck.nodal_sweep_3d_plain(*a, "smooth", pmask=pmask,
                                          nsweeps=nsw, corr=corrn)),
         nb + nbytes([corrn]), nodal_fused_ops("smooth+corr", nsw) * nodes,
         old_corr),
    ]
    return cases


def const_cases(torch, dtype_name, n, B):
    """Kernel 5's fused stages (ck.FUSED_SWEEPS sweeps, as the V-cycles call
    them) at n^3 on B fields: the viscous operator rho - mu lap of a seeded
    density in [1, 10], Dirichlet on every face at the 256^3 base and a
    coarse level, the coarse-fine ghost code (3) on config 5's finer
    patches; each beside the single passes that a V-cycle's level visit
    calls instead above mg.CONST_FUSED_MAX_CELLS (the sweeps, the residual,
    the plain restriction and max|r|; the plain prolongation and add, then
    the sweeps)."""
    from varden_tpu_torch.ops import cuda_kernels as ck
    from varden_tpu_torch.solvers import mg
    nsw = ck.FUSED_SWEEPS
    dev, dt_ = torch.device("cuda"), getattr(torch, dtype_name)
    N = (n,) * 3
    dx = (1.0 / n,) * 3
    code = 3 if n in N_AMR_PATCHES[1:] else 2
    ell = [(code, code)] * 3
    rho = 5.5 + 4.5 * smooth(torch, N, 80, 1.0, dev, dt_)
    mu = 0.5 * dx[0] * 1.0e-3  # dt visc_coef / 2 at dt = dx
    lev = mg.make_level(N, dx, ell, rho, (mu,) * 3, 1.0)
    coef = [mu / h ** 2 for h in dx] + [1.0]
    phi = smooth(torch, (B,) + N, 81, 0.5, dev, dt_)
    rhs = smooth(torch, (B,) + N, 82, 2.0, dev, dt_)
    corr = smooth(torch, (B,) + (n // 2,) * 3, 83, 0.1, dev, dt_)
    bv = [[0.0, 0.0]] * 3
    g = (phi, rhs, lev.inv_diag, coef, ell, bv)
    kw = dict(aco=rho)
    # phi and rhs in and phi out per field; inv_diag and aco once
    fb = 3 * nbytes([phi]) + nbytes([lev.inv_diag, rho])
    tag = f"{n}^3 B{B}"
    cells = B * n ** 3

    def sweeps(p):
        for _ in range(nsw):
            p = ck.gsrb_const_sweep_3d(p, *g[1:], **kw)
        return p

    def old_restrict():
        p = sweeps(phi)
        r = ck.gsrb_const_sweep_3d(p, rhs, None, coef, ell, bv,
                                   emit="residual", **kw)
        return p, mg._cell_avg_down(r, 3), r.abs().max()

    return [
        ("gsrb_const_sweep_3d", f"smooth_restrict {tag}",
         (lambda: ck.gsrb_const_sweep_3d(*g, emit="smooth_restrict",
                                         nsweeps=nsw, **kw)),
         (lambda: ck.gsrb_const_sweep_3d_plain(*g, emit="smooth_restrict",
                                               nsweeps=nsw, **kw)),
         fb + nbytes([phi]) // 8,
         const_fused_ops("smooth_restrict", nsw) * cells, old_restrict),
        ("gsrb_const_sweep_3d", f"smooth+corr {tag}",
         (lambda: ck.gsrb_const_sweep_3d(*g, emit="smooth", nsweeps=nsw,
                                         corr=corr, **kw)),
         (lambda: ck.gsrb_const_sweep_3d_plain(*g, emit="smooth",
                                               nsweeps=nsw, corr=corr, **kw)),
         fb + nbytes([corr]), const_fused_ops("smooth+corr", nsw) * cells,
         (lambda: sweeps(phi + ck.cell_prolong(corr, (2, 2, 2))))),
    ]


def gsrb2d_fused_cases(torch, dtype_name, n, ell):
    """Kernel 8's fused stages (ck.FUSED_SWEEPS sweeps, as the V-cycles call
    them) at n^2: the MAC operator of a seeded density in [1, 2] with the
    BC codes ``ell`` (Dirichlet values where the code is 2), each beside
    the single passes that a V-cycle's level visit called before (two
    two-launch sweeps, the residual, the plain restriction and max|r|; the
    plain prolongation and add, two sweeps)."""
    from varden_tpu_torch.ops import cuda_kernels as ck
    from varden_tpu_torch.solvers import mg
    nsw = ck.FUSED_SWEEPS
    dev, dt_ = torch.device("cuda"), getattr(torch, dtype_name)
    N = (n, n)
    dx = (1.0 / n,) * 2
    rho = 1.5 + 0.5 * smooth(torch, N, 80, 1.0, dev, dt_, dm=2)
    beta = []
    for d in range(2):
        lo = [slice(None)] * 2
        hi = [slice(None)] * 2
        lo[d], hi[d] = slice(0, 1), slice(n - 1, n)
        q = torch.cat([rho[tuple(lo)], rho, rho[tuple(hi)]], dim=d)
        beta.append((2.0 / (q.narrow(d, 0, n + 1)
                            + q.narrow(d, 1, n + 1))).contiguous())
    del rho
    lev = mg.make_level(N, dx, ell, torch.zeros(N, dtype=dt_, device=dev),
                        tuple(beta), 0.0)
    bv = [[0.3 if c == 2 else 0.0 for c in side] for side in ell]
    phi = smooth(torch, N, 81, 0.5, dev, dt_, dm=2)
    rhs = smooth(torch, N, 82, 50.0, dev, dt_, dm=2)
    corr = smooth(torch, (n // 2,) * 2, 83, 0.1, dev, dt_, dm=2)
    g = (phi, rhs, lev.inv_diag, lev.beta, lev.dx, ell, bv)
    fb = 4 * nbytes([phi]) + nbytes(beta)  # phi, rhs, inv_diag in, phi out
    cells = n * n
    tag = f"{n}^2"

    def sweeps(p):
        for _ in range(nsw):
            p = ck.gsrb_sweep_2d(p, *g[1:])
        return p

    def old_restrict():
        p = sweeps(phi)
        r = ck.gsrb_sweep_2d(p, *g[1:], emit="residual")
        return p, mg._cell_avg_down(r, 2), r.abs().max()

    return [
        ("gsrb_sweep_2d", f"smooth_restrict {tag}",
         (lambda: ck.gsrb_sweep_2d(*g, emit="smooth_restrict", nsweeps=nsw)),
         (lambda: ck.gsrb_sweep_2d_plain(*g, emit="smooth_restrict",
                                         nsweeps=nsw)),
         fb + nbytes([phi]) // 4, gsrb2d_fused_ops("smooth_restrict", nsw)
         * cells, old_restrict),
        ("gsrb_sweep_2d", f"smooth+corr {tag}",
         (lambda: ck.gsrb_sweep_2d(*g, emit="smooth", nsweeps=nsw,
                                   corr=corr)),
         (lambda: ck.gsrb_sweep_2d_plain(*g, emit="smooth", nsweeps=nsw,
                                         corr=corr)),
         fb + nbytes([corr]), gsrb2d_fused_ops("smooth+corr", nsw) * cells,
         (lambda: sweeps(phi + ck.cell_prolong(corr, (2, 2))))),
    ]


# kernel 8's fused stages in phase 2: the 2-D main path's finest level with
# its Neumann walls, a level of its hierarchy periodic in x with Dirichlet
# values in y, and a coarse-fine (ghost) level of config 3's size
GSRB2D_FUSED_SHAPES = ((N_2D, [(1, 1), (1, 1)]), (512, [(0, 0), (2, 2)]),
                       (64, [(3, 3), (3, 3)]))


def kernel_cases_gsrb2d_fused(torch, dtype_name):
    cases = []
    for n, ell in GSRB2D_FUSED_SHAPES:
        cases += gsrb2d_fused_cases(torch, dtype_name, n, ell)
    return cases


# kernel 5's fused stages in phase 2: (n, B) at the base, config 5's finer
# patches and a coarse level of the viscous hierarchies
CONST_FUSED_SHAPES = ((256, 3), (256, 1), (240, 3), (384, 3), (64, 3))


def kernel_cases_smoothers(torch, dtype_name):
    """The fused stages of kernels 3 and 4 at 256^3 and config 5's 240^3
    and 384^3, and kernel 5's at CONST_FUSED_SHAPES."""
    cases = []
    for n in N_AMR_PATCHES:
        cases += smoother_cases(torch, dtype_name, n)
    for n, B in CONST_FUSED_SHAPES:
        cases += const_cases(torch, dtype_name, n, B)
    return cases


def kernel_cases_velpred(torch, dtype_name):
    """Kernel 1 at BASELINE config 5's level shapes (256^3 with its walls;
    240^3 and 384^3, interior patches whose every side is coarse-fine), in
    float32 and float64: config 5's Sim, smooth seeded u and force."""
    from varden_tpu_torch.config import INTERIOR, VardenConfig
    from varden_tpu_torch.ops import cuda_godunov as cg
    from varden_tpu_torch.state import Sim
    cases = []
    for n in N_AMR_PATCHES:
        sim = Sim(VardenConfig(**cfg5_kw(n, dtype_name)), device="cuda")
        dev, dt_, ng, N = sim.device, sim.dtype, sim.ng, sim.n_cell
        pbc = (sim.phys_bc if n == N_AMR_PATCHES[0]
               else ((INTERIOR, INTERIOR),) * 3)
        u = smooth(torch, (3,) + N, 90, 0.5, dev, dt_)
        f = smooth(torch, (3,) + N, 91, 0.3, dev, dt_)
        a = (sim.fill_vel(u), sim.fill_extrap(f, ng), 0.5 * sim.dx[0],
             sim.dx, pbc, [sim.adv_bc[d] for d in range(3)], ng, N,
             sim.cfg.slope_order, sim.cfg.use_minion)
        del u, f
        faces = 3 * (n + 1) * n * n * a[0].element_size()
        cases.append(("velpred_3d_fused", f"velocity {n}^3",
                      (lambda a=a: cg.velpred_3d_fused(*a)),
                      (lambda a=a: cg.velpred_3d_plain(*a)),
                      nbytes(a[:2]) + faces,
                      velpred_ops(sim.cfg.slope_order) * n ** 3))
    return cases


def rt_level(torch, n, dtype_name):
    """Config 4's MAC operator at n^3 on the card: the level (beta = 1/rho
    on faces of the Rayleigh-Taylor density), its elliptic BCs (periodic x
    and y, Neumann z), and a smooth seeded phi and rhs."""
    from varden_tpu_torch import problems, projection
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.solvers import mg
    from varden_tpu_torch.state import Sim
    sim = Sim(VardenConfig(**rt_kw(n, dtype_name)), device="cuda")
    N, dev, dt_ = sim.n_cell, sim.device, sim.dtype
    beta = projection.mk_mac_coeffs(sim, problems.initdata(sim).s[0])
    ell_bc = [tuple(sim.ell_bc[sim.press_comp][d]) for d in range(3)]
    lev = mg.make_level(N, sim.dx, ell_bc, sim.zeros(N), beta, 0.0)
    return (lev, ell_bc, smooth(torch, N, 50, 0.5, dev, dt_),
            smooth(torch, N, 51, 50.0, dev, dt_))


def kernel_cases_rt(torch, dtype_name):
    """Kernel 7 at config 4's finest MAC level, 128^3, and at 256^3, with
    config 4's boundaries: the single sweep of a phi padded by
    mg._pad_ghost, and the fused stages of a V-cycle's level visit
    (ck.FUSED_SWEEPS sweeps, as the V-cycles call them), each beside the
    composition it replaces (the ghost pad and the padded sweep twice,
    then kernel 3's restrict emit; the prolongation, its add, and the pad
    and sweep twice); beside them kernel 3's sweep of the same operator
    (the exact sweep that the padded one replaces on these levels)."""
    from varden_tpu_torch.ops import cuda_kernels as ck
    from varden_tpu_torch.solvers import mg
    nsw = ck.FUSED_SWEEPS
    cases = []
    for n in N_RT_PADDED:
        lev, ell_bc, phi, rhs = rt_level(torch, n, dtype_name)
        bv = [[0.0, 0.0]] * 3
        pad = mg._pad_ghost(phi, ell_bc, bv, 3)
        cells = n ** 3
        a = (pad, rhs, lev.inv_diag, list(lev.beta), lev.dx)
        cases.append(("gsrb_sweep_3d", f"sweep {n}^3",
                      (lambda a=a: ck.gsrb_sweep_3d(*a)),
                      (lambda a=a: ck.gsrb_sweep_3d_plain(*a)),
                      nbytes([pad, rhs, lev.inv_diag, *lev.beta])
                      + nbytes([rhs]), GSRB_OPS["sweep"] * cells))
        corr = smooth(torch, (n // 2,) * 3, 52, 0.1, phi.device, phi.dtype)
        f = (phi, rhs, lev.inv_diag, lev.beta, lev.dx)
        fkw = dict(ell_bc=ell_bc, bvals=bv, nsweeps=nsw)
        fb = 4 * nbytes([phi]) + nbytes(lev.beta)  # phi, rhs, inv in, phi out

        def sweeps(p, f=f, ell_bc=ell_bc, bv=bv):
            for _ in range(nsw):
                p = ck.gsrb_sweep_3d(mg._pad_ghost(p, ell_bc, bv, 3), *f[1:])
            return p

        def old_restrict(f=f, ell_bc=ell_bc, bv=bv, sweeps=sweeps):
            p = sweeps(f[0])
            return (p, *ck.gsrb_var_sweep_3d(p, *f[1:], ell_bc, bv,
                                             emit="restrict"))

        cases.append(("gsrb_sweep_3d", f"smooth_restrict {n}^3",
                      (lambda f=f, k=fkw: ck.gsrb_sweep_3d(
                          *f, emit="smooth_restrict", **k)),
                      (lambda f=f, k=fkw: ck.gsrb_sweep_3d_plain(
                          *f, emit="smooth_restrict", **k)),
                      fb + nbytes([phi]) // 8,
                      gsrb_fused_ops("smooth_restrict", nsw) * cells,
                      old_restrict))
        cases.append(("gsrb_sweep_3d", f"smooth+corr {n}^3",
                      (lambda f=f, k=fkw, c=corr: ck.gsrb_sweep_3d(
                          *f, emit="smooth", corr=c, **k)),
                      (lambda f=f, k=fkw, c=corr: ck.gsrb_sweep_3d_plain(
                          *f, emit="smooth", corr=c, **k)),
                      fb + nbytes([corr]),
                      gsrb_fused_ops("smooth+corr", nsw) * cells,
                      (lambda f=f, c=corr, sweeps=sweeps: sweeps(
                          f[0] + ck.cell_prolong(c, (2, 2, 2))))))
        g = (phi, rhs, lev.inv_diag, lev.beta, lev.dx, ell_bc, bv)
        cases.append(("gsrb_var_sweep_3d", f"sweep per-xy {n}^3",
                      (lambda g=g: ck.gsrb_var_sweep_3d(*g)),
                      (lambda g=g: ck.gsrb_var_sweep_3d_plain(*g)),
                      4 * nbytes([phi]) + nbytes(lev.beta),
                      GSRB_OPS["sweep"] * cells))
    return cases


def pad_ghost_report(torch, dtype_name, reps):
    """Device ms of mg._pad_ghost (plain torch: three concatenations) at
    kernel 7's shapes: the single padded sweeps paid it once per sweep,
    which the fused stages no longer do."""
    from varden_tpu_torch.solvers import mg
    out = {}
    for n in N_RT_PADDED:
        _lev, ell_bc, phi, _rhs = rt_level(torch, n, dtype_name)
        ms = cuda_ms(torch, lambda: mg._pad_ghost(phi, ell_bc,
                                                  [[0.0, 0.0]] * 3, 3), reps)
        out[n] = ms
        print(f"  mg._pad_ghost {n}^3 {dtype_name}: {ms:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    return out


def phase_kernels(torch, dtype_name, reps, cases_fn=kernel_cases):
    tol = TOL_KERNEL[dtype_name]
    rows = []
    for name, case, kern, plain, b, ops, *old in cases_fn(torch, dtype_name):
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        errs = max_errs(out, ref)
        del out, ref
        bad = [i for i, (e, sc) in enumerate(errs)
               if not e <= tol * max(sc, 1e-30)]
        ok = not bad
        err = max(e for e, _ in errs)
        ms = cuda_ms(torch, kern, reps)
        plain_ms = cuda_ms(torch, plain, max(1, reps // 4))
        # the old single emits that a fused stage replaces, where given
        old_ms = cuda_ms(torch, old[0], reps) if old else None
        bms, by = bound(b, ops, dtype_name)
        # max_abs_err: the largest over the outputs; errs, ref_max and tol
        # each output's
        row = dict(name=name, case=case, dtype=dtype_name, max_abs_err=err,
                   errs=[e for e, _ in errs], ref_max=[sc for _, sc in errs],
                   tol=[tol * sc for _, sc in errs], ok=ok, ms=ms,
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by, bytes=b,
                   ops=ops, old_ms=old_ms)
        each = ", ".join(f"{e:.3e} (tol {tol:.0e} x max|ref| {sc:.3e})"
                         for e, sc in errs)
        print(f"  {name:24s} {case:12s} {dtype_name}: max abs err {each} "
              f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bms:.4f} ms by {by} "
              f"({b} B, {ops:.0f} ops)"
              + (f", old emits {old_ms:.4f} ms" if old else ""), flush=True)
        need(ok, f"{name} ({case}, {dtype_name}) disagrees with its plain "
                 f"version in output(s) {bad}: (max abs err, max|ref|) "
                 f"{errs}, tol {tol} x max|ref|")
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 3: one step on the card against the CPU plain path, float64
# ---------------------------------------------------------------------------

def bubble_kw(n, dtype_name, **over):
    kw = dict(dim_in=3, prob_type=1, n_cellx=n, n_celly=n, n_cellz=n,
              grav=-9.8, dtype=dtype_name, visc_coef=0.0, diff_coef=0.0,
              cflfac=0.5, init_iter=1, plot_int=-1, chk_int=-1, max_levs=1)
    for ax in "xyz":
        kw[f"bc{ax}_lo"] = kw[f"bc{ax}_hi"] = 15
    kw.update(over)
    return kw


def bubble2d_kw(n, dtype_name, **over):
    """The 2-D bubble between four no-slip walls, viscous (visc_coef 1e-3,
    cflfac 0.9): the published viscous 2-D configuration, at n^2."""
    kw = dict(dim_in=2, prob_type=1, n_cellx=n, n_celly=n, grav=-9.8,
              dtype=dtype_name, visc_coef=1.0e-3, diff_coef=0.0, cflfac=0.9,
              init_iter=1, plot_int=-1, chk_int=-1, max_levs=1,
              bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15)
    kw.update(over)
    return kw


def cfg5_kw(n, dtype_name, **over):
    """BASELINE config 5 as bench.py:314-320 sets it (cfg5_config): the 3-D
    bubble on an n^3 base with two refined levels, no regrid, visc_coef
    1e-3, cflfac 0.5, init_shrink 0.5, no pressure iteration, no-slip walls
    on all six faces."""
    kw = bubble_kw(n, dtype_name, max_levs=3, regrid_int=-1,
                   visc_coef=1.0e-3, cflfac=0.5, init_shrink=0.5, init_iter=0)
    kw.update(over)
    return kw


def rt_kw(n, dtype_name, **over):
    """BASELINE config 4 as bench.py:303-307 sets it: 3-D Rayleigh-Taylor
    (prob_type 3) at n^3, periodic in x and y, no-slip walls in z,
    visc_coef 1e-3, cflfac 0.9, the other settings at their defaults (four
    pressure iterations)."""
    kw = dict(dim_in=3, prob_type=3, n_cellx=n, n_celly=n, n_cellz=n,
              grav=-9.8, dtype=dtype_name, visc_coef=1.0e-3, cflfac=0.9,
              bcx_lo=-1, bcx_hi=-1, bcy_lo=-1, bcy_hi=-1, bcz_lo=15,
              bcz_hi=15, plot_int=-1, chk_int=-1)
    kw.update(over)
    return kw


def cfg3_kw(dtype_name):
    """BASELINE config 3 (bench.py:298-302): the viscous 2-D bubble on a
    64^2 base, max_levs 2, regrid every 4 steps, init_shrink 0.1."""
    return bubble2d_kw(64, dtype_name, max_levs=2, regrid_int=4,
                       init_shrink=0.1)


def phase_step(torch, kw):
    """One float64 step of the configuration ``kw`` on the card against the
    plain path on the CPU, from one numpy-made state."""
    import numpy as np
    from varden_tpu_torch import advance, problems
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.state import Sim, state_from_numpy, state_to_numpy

    cfg = VardenConfig(**kw)
    dm, n = cfg.dm, cfg.n_cell[0]
    cpu, gpu = Sim(cfg, device="cpu"), Sim(cfg, device="cuda")
    st = problems.initdata(cpu)
    rng = np.random.RandomState(11)
    arrs, _ = state_to_numpy(st)
    k = np.pi * (np.arange(n) + 0.5) / n
    for c in range(dm):  # a smooth seeded velocity so that the step moves
        mode = np.float64(0.2)
        for m in rng.randint(1, 3, size=dm):
            mode = mode[..., None] * np.sin(m * k)
        arrs["u"][c] = mode
    st_c, _ = state_from_numpy(cpu, arrs)
    st_g, _ = state_from_numpy(gpu, arrs)
    dt = advance.estdt(cpu, st_c, -1.0)
    t0 = time.perf_counter()
    out_c, dc = advance.advance_timestep(cpu, st_c, dt, 4)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_g, dg = advance.advance_timestep(gpu, st_g, dt, 4)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    res = {}
    for key in ("u", "s", "gp", "p"):
        a = getattr(out_c, key)
        b = getattr(out_g, key).cpu()
        scale = max(1.0, float(a.abs().max()))
        err = float((a - b).abs().max())
        res[key] = err
        print(f"  step {n}^{dm} float64 {key:2s}: max abs err {err:.3e} "
              f"(tol {TOL_STEP:.0e} x {scale:.3e})", flush=True)
        need(err <= TOL_STEP * scale, f"step field {key} on the card differs "
                                      f"from the CPU path by {err}")
        need(bool(torch.isfinite(b).all()), f"step field {key} not finite")
    print(f"  step wall: card {t_gpu:.3f} s (first call, kernels loaded), "
          f"CPU {t_cpu:.3f} s; div_after card "
          f"{float(dg['div_after']):.3e} CPU {float(dc['div_after']):.3e}",
          flush=True)
    return res


def run_states(cfg, device):
    """Varden.run of ``cfg`` on ``device`` (None: the card): the patches'
    (lo, n), the list of per-patch States and the wall seconds."""
    import torch
    from varden_tpu_torch.driver import Varden
    t0 = time.perf_counter()
    v = Varden(cfg, device=device)
    states = v.run()
    if device is None:
        torch.cuda.synchronize()
    boxes = ([(tuple(s.lo), tuple(s.n)) for s in v.geom.specs] if v.ml
             else [((0,) * cfg.dm, tuple(cfg.n_cell))])
    return boxes, states if v.ml else [states], time.perf_counter() - t0


def hold_card_to_cpu(torch, card, cpu, steps):
    """The card's run_states against the CPU plain path's, float64: the
    same boxes, every field of every level within TOL_STEP of its size."""
    (boxes, sg, tg), (boxes_c, sc, tc) = card, cpu
    need(boxes == boxes_c, f"AMR boxes differ between the card and the "
                           f"CPU: {boxes} against {boxes_c}")
    errs = {}
    for lev, (a, b) in enumerate(zip(sc, sg)):
        for key in ("u", "s", "gp", "p"):
            x, y = getattr(a, key), getattr(b, key).cpu()
            scale = max(1.0, float(x.abs().max()))
            err = float((x - y).abs().max())
            errs[f"{lev}:{key}"] = err
            need(bool(torch.isfinite(y).all()), f"level {lev} {key} not "
                                                "finite on the card")
            need(err <= TOL_STEP * scale, f"AMR level {lev} field {key} on "
                 f"the card differs from the CPU path by {err}")
    print(f"  {steps} steps float64, levels {[b[1] for b in boxes]}: "
          f"max abs err card vs CPU {max(errs.values()):.3e} (tol "
          f"{TOL_STEP:.0e} x field size); wall card {tg:.3f} s (kernels "
          f"loaded), CPU {tc:.3f} s", flush=True)
    return {"levels": boxes, "max_abs_err": errs, "card_s": tg, "cpu_s": tc}


def phase_run(torch, kw, steps):
    """Varden.run of the configuration ``kw`` for ``steps`` steps on the
    card and on the CPU plain path, float64: the same boxes (multi-level),
    every field of every level within TOL_STEP of its size."""
    from varden_tpu_torch.config import VardenConfig
    cfg = VardenConfig(**kw, max_step=steps)
    cpu = run_states(cfg, "cpu")
    return hold_card_to_cpu(torch, run_states(cfg, None), cpu, steps)


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def counters():
    from varden_tpu_torch.ops import cuda_godunov as cg
    from varden_tpu_torch.ops import cuda_kernels as ck
    from varden_tpu_torch.ops import cuda_update as cu
    return {"velpred_3d_fused": cg.velpred_3d_fused,
            "mkflux_update_3d_fused": cg.mkflux_update_3d_fused,
            "gsrb_var_sweep_3d": ck.gsrb_var_sweep_3d,
            "nodal_sweep_3d": ck.nodal_sweep_3d,
            "gsrb_const_sweep_3d": ck.gsrb_const_sweep_3d,
            "gsrb_sweep_2d": ck.gsrb_sweep_2d,
            "velpred_2d_fused": cg.velpred_2d_fused,
            "mkflux_2d_fused": cg.mkflux_2d_fused,
            "update_3d": cu.update_3d,
            "mkflux_3d_fused": cg.mkflux_3d_fused,
            "gsrb_sweep_3d": ck.gsrb_sweep_3d}


# kernels 3, 4, 5, 7 and 8 count the launches of their fused V-cycle stages
# apart (key "<name>:fused"): a 3-D path's V-cycles smooth through them;
# config 4's MAC levels, which are periodic in x, through kernel 7's (the
# sweeps' ghost rings held at their start), whose last sweep of a
# pre-smooth takes the residual and the restriction too. Kernel 5's
# fused stages take the viscous solves' levels of at most
# mg.CONST_FUSED_MAX_CELLS cells, and every V-cycle of a 3-D path's viscous
# solve visits such levels (its hierarchy coarsens to 8^3). A 2-D path's
# MAC V-cycles smooth through kernel 8's
FUSED_3D = ("gsrb_var_sweep_3d", "nodal_sweep_3d", "gsrb_const_sweep_3d")
FUSED = FUSED_3D + ("gsrb_sweep_2d", "gsrb_sweep_3d")
FUSED_RT = ("nodal_sweep_3d", "gsrb_const_sweep_3d", "gsrb_sweep_3d")


def zero_counts(fns):
    for f in fns.values():
        f.launches = 0
    for k in FUSED:
        fns[k].fused_launches = 0


def read_counts(fns):
    out = {k: f.launches for k, f in fns.items()}
    out.update({f"{k}:fused": fns[k].fused_launches for k in FUSED})
    return out


def check_launches(launches, expect, fused):
    """Every kernel of ``expect`` launched and no other; the fused stages
    of the kernels in ``fused`` launched, of the others not."""
    for k, c in launches.items():
        base = k.split(":")[0]
        on = (k == base and base in expect) or (k != base and base in fused)
        if on:
            need(c > 0, f"{k} was not launched on this path")
        else:
            need(c == 0, f"{k} is not on this path but launched {c}x")


def check_velpred2d_calls(per_step):
    """Kernel 9 is two launches a call (the tie epsilon, one tile pass), and
    a step calls it once a level."""
    for rec in per_step:
        calls = len(rec.get("levels", [None]))
        need(rec["launches"]["velpred_2d_fused"] == 2 * calls,
             f"step {rec['step']}: velpred_2d_fused launched "
             f"{rec['launches']['velpred_2d_fused']}x for {calls} call(s), "
             "not 2 a call")


def phase_main(torch, kw, steps, expect, bubble=True, fused=None):
    """Drive Varden on the configuration ``kw`` for ``steps`` regular steps;
    ``expect`` names the kernels that must have launched, every other one
    must not have; ``fused`` (default: those of FUSED in ``expect``) the
    kernels whose fused stages must have. ``bubble``: hold the density to
    the bubble's range [1, densfact]."""
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.driver import Varden

    cfg = VardenConfig(**kw, max_step=steps)
    tol_rho = TOL_RHO_VISCOUS if cfg.visc_coef > 0.0 else TOL_RHO
    rho_hi = 10.0 if cfg.dm == 3 else 2.0  # the bubble's densfact
    fns = counters()
    if fused is None:
        fused = tuple(k for k in FUSED if k in expect)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    t_start = time.perf_counter()
    v = Varden(cfg)  # the card: no device named
    state = v.initialize()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_start
    init_counts = read_counts(fns)
    per_step = []
    while v.istep < steps:
        before = read_counts(fns)
        cyc0 = dict(CYCLES)
        t0 = time.perf_counter()
        state = v.step(state)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        d = v.last_diag
        cycles = {k: CYCLES[k] - cyc0[k] for k in CYCLES}
        gamma = visc_gamma(v, state) if cfg.visc_coef > 0.0 else None
        rec = dict(step=v.istep, dt=v.dt, seconds=sec, cells=list(cfg.n_cell),
                   cells_per_s=math.prod(cfg.n_cell) / sec,
                   div_before=float(d["div_before"]),
                   div_after=float(d["div_after"]),
                   mac_ratio=float(d["mac_ratio"]),
                   hg_ratio=float(d["hg_ratio"]),
                   rho_min=float(d["smin"]), rho_max=float(d["smax"]),
                   umax=float(d["umax"]),
                   gamma=gamma, visc_cycles=int(d.get("visc_cycles", 0)),
                   visc_ratio=float(d.get("visc_ratio", 0.0)),
                   cycles=cycles,
                   launches={k: c - before[k]
                             for k, c in read_counts(fns).items()})
        per_step.append(rec)
        print(f"  step {rec['step']}: div(umac) before/after MAC "
              f"{rec['div_before']:.6e} / {rec['div_after']:.6e} "
              f"(solver ratios MAC {rec['mac_ratio']:.3f} HG "
              f"{rec['hg_ratio']:.3f}); density min/max {rec['rho_min']:.9f}"
              f" / {rec['rho_max']:.9f}; {sec:.4f} s; "
              f"{rec['cells_per_s']:.6e} cells/s; launches "
              f"{rec['launches']}", flush=True)
    launches = read_counts(fns)
    peak = torch.cuda.max_memory_allocated()
    print(f"  init (initial projection + {cfg.init_iter} pressure iteration):"
          f" {t_init:.4f} s, launches {init_counts}", flush=True)
    print(f"  main path launches {launches}; peak device memory "
          f"{peak} bytes", flush=True)

    check_launches(launches, expect, fused)
    if "velpred_2d_fused" in expect:
        check_velpred2d_calls(per_step)
    for key in ("u", "s", "gp", "p"):
        need(bool(torch.isfinite(getattr(state, key)).all()),
             f"main path field {key} is not finite")
    rho = state.s[0]
    lo, hi = float(rho.min()), float(rho.max())
    need(not bubble or (1.0 - tol_rho <= lo and hi <= rho_hi + tol_rho),
         f"density left [1, {rho_hi}]: min {lo}, max {hi}")
    for rec in per_step:
        need(rec["mac_ratio"] <= 1.0 and rec["hg_ratio"] <= 1.0,
             f"step {rec['step']}: a projection stopped above its "
             f"tolerance (ratios {rec['mac_ratio']}, {rec['hg_ratio']})")
        need(rec["visc_ratio"] <= 1.0,
             f"step {rec['step']}: the viscous solve stopped above its "
             f"tolerance (ratio {rec['visc_ratio']})")
        need(rec["div_after"] < rec["div_before"],
             f"step {rec['step']}: the MAC projection did not reduce div")
    return v, state, launches, per_step, peak


def phase_main_ml(torch, cfg, steps, expect, label, fused=None):
    """Drive the multi-level Varden (initialize_ml, then step_ml) on
    ``cfg`` for ``steps`` regular steps on the card; ``expect`` and
    ``fused`` as for phase_main. Gates:
    each composite solve at or below its tolerance, div(umac) falling
    across the MAC projection, every field of every level finite and the
    density inside [1, densfact]."""
    from varden_tpu_torch.amr import solve as tsolve
    from varden_tpu_torch.driver import Varden
    tol_rho = TOL_RHO_VISCOUS if cfg.visc_coef > 0.0 else TOL_RHO
    rho_hi = 10.0 if cfg.dm == 3 else 2.0
    fns = counters()
    if fused is None:
        fused = tuple(k for k in FUSED if k in expect)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    tsolve.TRACE = []
    t_start = time.perf_counter()
    v = Varden(cfg)  # the card: no device named
    states = v.initialize_ml()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t_start
    init_counts = read_counts(fns)
    print(f"  {label}: levels {[s.n for s in v.geom.specs]} at "
          f"{[s.lo for s in v.geom.specs]} ({v.geom.cells()} cells); init "
          f"{t_init:.3f} s, launches {init_counts}", flush=True)
    solve_report("init", tsolve.TRACE)
    per_step = []
    while v.istep < steps:
        before = read_counts(fns)
        regrids = v.regrids
        tsolve.TRACE = []
        t0 = time.perf_counter()
        states = v.step_ml(states)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        d = v.last_diag
        rho = [(float(st.s[0].min()), float(st.s[0].max())) for st in states]
        rec = dict(step=v.istep, dt=v.dt, seconds=sec,
                   levels=[list(s.n) for s in v.geom.specs],
                   cells=v.geom.cells(), cells_per_s=v.geom.cells() / sec,
                   regrid=v.regrids > regrids,
                   div_before=float(d["div_before"]),
                   div_after=float(d["div_after"]),
                   mac_ratio=float(d["mac_ratio"]),
                   hg_ratio=float(d["hg_ratio"]),
                   visc_ratio=float(d.get("visc_ratio", 0.0)),
                   mac_outer=int(d["mac_outer"]), hg_outer=int(d["hg_outer"]),
                   visc_outer=[int(k) for k in d.get("visc_outer", [])],
                   rho_min=min(r[0] for r in rho),
                   rho_max=max(r[1] for r in rho),
                   umax=max(float(st.u.abs().max()) for st in states),
                   solves=tsolve.TRACE,
                   launches={k: c - before[k]
                             for k, c in read_counts(fns).items()})
        per_step.append(rec)
        print(f"  step {rec['step']}{' (regrid)' if rec['regrid'] else ''}:"
              f" div(umac) before/after MAC {rec['div_before']:.6e} / "
              f"{rec['div_after']:.6e}; outer cycles MAC {rec['mac_outer']} "
              f"HG {rec['hg_outer']} visc {rec['visc_outer']} (ratios "
              f"{rec['mac_ratio']:.3f} {rec['hg_ratio']:.3f} "
              f"{rec['visc_ratio']:.3f}); density min/max over levels "
              f"{rec['rho_min']:.9f} / {rec['rho_max']:.9f}; {sec:.4f} s; "
              f"{rec['cells_per_s']:.6e} cells/s; launches "
              f"{ {k: c for k, c in rec['launches'].items() if c} }",
              flush=True)
        solve_report(f"step {rec['step']}", rec["solves"])
    tsolve.TRACE = None
    launches = read_counts(fns)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {label} launches {launches}; peak device memory {peak} bytes",
          flush=True)
    check_launches(launches, expect, fused)
    if "velpred_2d_fused" in expect:
        check_velpred2d_calls(per_step)
    for lev, st in enumerate(states):
        for key in ("u", "s", "gp", "p"):
            need(bool(torch.isfinite(getattr(st, key)).all()),
                 f"{label} level {lev} field {key} is not finite")
    for rec in per_step:
        need(1.0 - tol_rho <= rec["rho_min"] and
             rec["rho_max"] <= rho_hi + tol_rho,
             f"step {rec['step']}: density left [1, {rho_hi}]: "
             f"{rec['rho_min']}, {rec['rho_max']}")
        need(max(rec["mac_ratio"], rec["hg_ratio"], rec["visc_ratio"]) <= 1.0,
             f"step {rec['step']}: a composite solve stopped above its "
             f"tolerance ({rec['mac_ratio']}, {rec['hg_ratio']}, "
             f"{rec['visc_ratio']})")
        need(rec["div_after"] < rec["div_before"],
             f"step {rec['step']}: the MAC projection did not reduce div")
    return v, states, launches, per_step, peak, t_init


IO_FUNCS = ("write_plotfile", "write_checkpoint", "read_checkpoint",
            "write_plotfile_ml", "write_checkpoint_ml", "read_checkpoint_ml")


class TimedIO:
    """For the duration of a with block, wrap the writers and readers of
    varden_tpu_torch.io.output (which the driver calls through the module)
    to record each call's seconds, the card synchronised before and
    after."""

    def __init__(self, torch):
        self.torch = torch
        self.secs = {}

    def __enter__(self):
        from varden_tpu_torch.io import output
        self.mod, self.orig = output, {}
        for name in IO_FUNCS:
            self.orig[name] = getattr(output, name)
            setattr(output, name, self._timed(name, self.orig[name]))
        return self

    def _timed(self, name, fn):
        def timed(*a, **k):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.torch.cuda.synchronize()
            self.secs.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return timed

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


def same_states(torch, a, b, what):
    """Two lists of per-patch States equal bitwise, field by field."""
    need(len(a) == len(b), f"{what}: {len(a)} patches against {len(b)}")
    for lev, (x, y) in enumerate(zip(a, b)):
        for key in ("u", "s", "gp", "p"):
            p, q = getattr(x, key), getattr(y, key)
            need(p.shape == q.shape and bool(torch.equal(p, q)),
                 f"{what}: patch {lev} field {key} differs (max abs "
                 f"{float((p - q).abs().max()) if p.shape == q.shape else 'shape'})")


def same_files(d1, d2, what):
    """Every file of directory d1 equal byte for byte to d2's."""
    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)
    names = files(d1)
    need(names == files(d2), f"{what}: the file lists differ")
    for f in names:
        with open(os.path.join(d1, f), "rb") as a, \
                open(os.path.join(d2, f), "rb") as b:
            need(a.read() == b.read(), f"{what}: {f} differs")
    return len(names)


def phase_io(torch):
    """Plotfiles, checkpoints and restarts on the card (phase 15): the RT
    inputs as published, cut to RT_IO_STEPS steps with a checkpoint every
    RT_IO_CHK, then config 4 at N_RT^3 in float32; all output goes to a
    temporary directory that is removed at the end."""
    import shutil
    import tempfile

    import numpy as np
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.driver import Varden, run_from_inputs
    from varden_tpu_torch.io import boxlib
    from varden_tpu_torch.io import output

    path = os.path.join(HERE, "inputs", "inputs_RayleighTaylor_3d")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    res = {}
    try:
        full, again = os.path.join(tmp, "full"), os.path.join(tmp, "again")
        over = dict(max_step=RT_IO_STEPS, chk_int=RT_IO_CHK)
        fns = counters()
        zero_counts(fns)
        with TimedIO(torch) as tio:
            t0 = time.perf_counter()
            v = run_from_inputs(path, plot_base_name=full + "/plt",
                                check_base_name=full + "/chk", **over)
            torch.cuda.synchronize()
            t_run = time.perf_counter() - t0
            launches = read_counts(fns)
            print(f"  RT inputs to step {v.istep} in {t_run:.3f} s, levels "
                  f"{[s.n for s in v.geom.specs]}, {v.regrids} regrids; "
                  f"launches { {k: c for k, c in launches.items() if c} }",
                  flush=True)
            for k in KERNELS_RT_AMR + ("gsrb_sweep_3d:fused",):
                need(launches[k] > 0, f"RT inputs: kernel {k} was not "
                                      "launched on this AMR path")
            plot_read = []
            for step in range(0, RT_IO_STEPS + 1, v.cfg.plot_int):
                t0 = time.perf_counter()
                names, t_plt, levels = boxlib.read_plotfile(
                    f"{full}/plt{step:05d}")
                plot_read.append(time.perf_counter() - t0)
                need(names[3] == "density" and levels and all(
                    bool(np.isfinite(a).all()) for a in levels),
                     f"plt{step:05d} did not read back finite")
            for step in range(RT_IO_CHK, RT_IO_STEPS + 1, RT_IO_CHK):
                _g, sts, hdr, hints = output.read_checkpoint_ml(
                    v.sim, f"{full}/chk{step:05d}")
                need(hdr["istep"] == step and hints is not None,
                     f"chk{step:05d} did not read back")
            same_states(torch, v.final_state, sts,
                        f"chk{RT_IO_STEPS:05d} read back")
            # the restart: a copy of the mid-run checkpoint, run to the end
            shutil.copytree(f"{full}/chk{RT_IO_CHK:05d}",
                            f"{again}/chk{RT_IO_CHK:05d}")
            t0 = time.perf_counter()
            v2 = run_from_inputs(path, plot_base_name=again + "/plt",
                                 check_base_name=again + "/chk",
                                 restart=RT_IO_CHK, **over)
            torch.cuda.synchronize()
            t_restart = time.perf_counter() - t0
            need(v2.istep == v.istep and v2.time == v.time,
                 f"the restart ended at step {v2.istep}, time {v2.time}")
            same_states(torch, v.final_state, v2.final_state,
                        f"RT inputs restarted from step {RT_IO_CHK}")
            nfiles = same_files(f"{full}/plt{RT_IO_STEPS:05d}",
                                f"{again}/plt{RT_IO_STEPS:05d}",
                                "the restart's last plotfile")
            print(f"  restart from chk{RT_IO_CHK:05d} to step {v2.istep} in "
                  f"{t_restart:.3f} s: every field of every patch equal "
                  f"bitwise, plt{RT_IO_STEPS:05d}'s {nfiles} files equal "
                  "byte for byte", flush=True)

            # config 4 at N_RT^3 float32: checkpoint at step 2, restart
            kw = rt_kw(N_RT, "float32", max_step=4, chk_int=2)
            c4, c4again = os.path.join(tmp, "c4"), os.path.join(tmp, "c4a")
            va = Varden(VardenConfig(**dict(kw, check_base_name=c4 + "/chk")))
            sa = va.run()
            shutil.copytree(f"{c4}/chk00002", f"{c4again}/chk00002")
            vb = Varden(VardenConfig(**dict(kw, restart=2,
                                            check_base_name=c4again
                                            + "/chk")))
            sb = vb.run()
            need(vb.istep == va.istep == 4 and vb.time == va.time,
                 "config 4's restart did not end where the run did")
            same_states(torch, [sa], [sb], f"config 4 {N_RT}^3 restarted "
                                           "from step 2")
            print(f"  config 4 {N_RT}^3 float32 restarted from chk00002: the "
                  "step-4 state equal bitwise", flush=True)
        secs = {k: {"calls": len(ts), "total_s": sum(ts),
                    "mean_s": sum(ts) / len(ts)}
                for k, ts in tio.secs.items()}
        secs["read_plotfile"] = {"calls": len(plot_read),
                                 "total_s": sum(plot_read),
                                 "mean_s": sum(plot_read) / len(plot_read)}
        for k, r in secs.items():
            print(f"  {k}: {r['calls']} calls, {r['mean_s']:.4f} s each "
                  f"({r['total_s']:.4f} s)", flush=True)
        res = {"launches": launches, "run_s": t_run,
               "restart_s": t_restart, "io_s": secs,
               "levels": [list(s.n) for s in v.geom.specs],
               "regrids": v.regrids}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def solve_report(tag, records):
    """One line per composite solve (amr.solve.TRACE): its outer cycles, the
    tolerance asked for (rel_eps * max|rhs|), the dtype's roundoff floor
    that the stopping test also admits, and the residual norm reached on
    each level."""
    for r in records:
        print(f"    {tag} {r['kind']} solve: {r['outer']} outer cycles, tol "
              f"{r['tol']:.3e}, floor {r['floor']:.3e}, residual by level "
              f"[{', '.join(f'{x:.3e}' for x in r['level_res'])}]",
              flush=True)


def mean_steady(per_step):
    """Mean seconds of the regular steps after the first."""
    steady = per_step[1:] or per_step
    return sum(r["seconds"] for r in steady) / len(steady)


def hold_f32_to_f64(per_step, per_step64, tol=TOL_F32_VS_F64):
    """The float32 run's density extrema and max|u| against the float64
    run's, step by step, within ``tol`` of their size."""
    for r32, r64 in zip(per_step, per_step64):
        for key in ("rho_min", "rho_max", "umax"):
            diff = abs(r32[key] - r64[key])
            print(f"  step {r32['step']} {key}: float32 {r32[key]:.9f} "
                  f"float64 {r64[key]:.9f}", flush=True)
            need(diff <= tol * abs(r64[key]),
                 f"step {r32['step']}: {key} differs by {diff} between the "
                 "float32 and the float64 main path")


def visc_gamma(v, state):
    """gamma = max offdiag/diag of the viscous operator rho - mu lap for the
    step just taken (its dt, the new density): below 0.5 mg.solve smooths
    with a budget of sweeps, from 0.5 on it goes to V-cycles."""
    from varden_tpu_torch import projection
    from varden_tpu_torch.solvers import mg
    sim = v.sim
    mu = 0.5 * v.dt * v.cfg.visc_coef
    ell, _ = projection.comp_bc(sim, 0)
    rho = state.s[0]
    lev = mg.make_level(sim.n_cell, sim.dx, ell, rho, (mu,) * sim.dm, 1.0)
    return float(((lev.diag - rho) / lev.diag).max())


def viscous_report(per_step):
    """How the viscous solve ran on a main path, per step: gamma, the
    V-cycles it took, its residual over its tolerance, and (3-D; in 2-D it
    runs on plain tensor code and the count is 0) the launches of the
    constant-coefficient kernel (lap(u) 1, each residual 1, each sweep 2,
    each fused stage 1, on every level)."""
    keys = ("gamma", "visc_cycles", "visc_ratio")
    out = {k: [rec[k] for rec in per_step] for k in keys}
    out["launches"] = [rec["launches"]["gsrb_const_sweep_3d"]
                       for rec in per_step]
    print(f"  viscous solve per step: gamma {out['gamma']} (>= 0.5: no "
          f"smoothing-only path); V-cycles {out['visc_cycles']}; residual / "
          f"tolerance {out['visc_ratio']}; gsrb_const launches "
          f"{out['launches']}", flush=True)
    return out


def profile_step(torch, v, state, path):
    """One more step under torch.profiler; the kernel table to ``path``.
    Returns the step's wall seconds (the profiler slows the host), the
    device time summed over the kernels, the share of it in the package's
    own kernels (namespace vt), and per part of the step (the ranges
    advance_timestep and ml_advance record) the host seconds spent inside
    it and the
    device seconds of the PyTorch ops started inside it (the step::
    spans; the solvers' spans nest inside them). The profiler does
    not put a kernel launched from outside a PyTorch op under a range, so
    the package's own kernels are not in any part's device seconds;
    "other" is the rest of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from varden_tpu_torch.advance import RANGES
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        (v.step_ml if v.ml else v.step)(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    table = avgs.table(sort_by="cuda_time_total", row_limit=80)
    with open(path, "w") as fh:
        fh.write(table)
    print(f"  profile of step {v.istep} written to {path}", flush=True)
    print("\n".join(table.splitlines()[:30]), flush=True)
    # the kernels' own rows only: a host op's row repeats its kernels'
    # time, and so does a range's mirror on the device
    rows = [e for e in avgs if e.device_type == DeviceType.CUDA
            and e.key not in RANGES]
    busy = sum(e.self_device_time_total for e in rows) * 1e-6
    own = sum(e.self_device_time_total for e in rows
              if " vt::" in e.key) * 1e-6
    parts = {e.key.split("::")[1]: {
                 "host_s": e.cpu_time_total * 1e-6,
                 "torch_device_s": e.device_time_total * 1e-6}
             for e in avgs
             if e.key in RANGES and e.key.startswith("step::")
             and e.device_type == DeviceType.CPU}
    parts["other"] = {
        "host_s": wall - sum(p["host_s"] for p in parts.values()),
        "torch_device_s": busy - own - sum(p["torch_device_s"]
                                           for p in parts.values())}
    print(f"  profiled step: {wall:.4f} s on the host's clock, device busy "
          f"{busy:.4f} s (idle share {1.0 - busy / wall:.3f}), {own:.4f} s "
          "of it in the package's own kernels; by part, host seconds / "
          "device seconds of its PyTorch ops: "
          + ", ".join(f"{k} {p['host_s']:.4f} / {p['torch_device_s']:.4f}"
                      for k, p in parts.items()), flush=True)
    return {"wall_s": wall, "device_s": busy, "own_kernels_device_s": own,
            "parts": parts}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 16: the decomposed single-level path, gloo ranks sharing the card
# ---------------------------------------------------------------------------

# the V-cycles mg and nodal enter at their finest level, by solver
CYCLES = {"mg": 0, "nodal": 0}
N_DECOMP_CHECK = 32
TOL_DECOMP_F64 = 1e-10
TOL_DECOMP_F32 = 1e-4
DECOMP_TIMEOUT = 420.0


def decomp_cells():
    """Phase 16's cells by key: the configuration, its steps, the rank
    counts it runs on, the kernels its path launches, its label, whether
    the density is held to the bubble's range, and (``widen``) whether its
    float32 gate widens to twice the one-rank float32 run's distance from
    float64. A float32 cell runs in float64 first, on the same ranks: that
    run is held to the one-rank float64 run as a float64 cell is."""
    return {
        "check": dict(kw=bubble_kw(N_DECOMP_CHECK, "float64",
                                   visc_coef=1.0e-3),
                      steps=1, ranks=(2, 4), expect=KERNELS_3D,
                      label=f"viscous 3-D bubble {N_DECOMP_CHECK}^3"),
        # mesh_shape(2) splits y, mesh_shape(4) x and y: kernel 7's ring
        # sweep on blocks whose periodic x seam is local, then crosses ranks
        "rt": dict(kw=rt_kw(N_DECOMP_CHECK, "float64"), steps=1,
                   ranks=(2, 4), expect=KERNELS_RT, bubble=False,
                   label=f"config 4's geometry {N_DECOMP_CHECK}^3 (periodic "
                         "x and y)"),
        "headline": dict(kw=bubble_kw(256, "float32", visc_coef=1.0e-3),
                         steps=STEPS_SHORT, ranks=(4,), expect=KERNELS_3D,
                         label="headline 256^3"),
        "2d": dict(kw=bubble2d_kw(N_2D_PUBLISHED, "float32"),
                   steps=STEPS_SHORT,
                   ranks=(4,), expect=KERNELS_2D, widen=True,
                   label=f"config 2's geometry {N_2D_PUBLISHED}^2"),
    }


def count_cycles():
    """Count into CYCLES the V-cycles that mg and nodal enter at their
    finest level (the recursion calls the modules' globals)."""
    from varden_tpu_torch.solvers import mg, nodal
    for module, key, lev_pos in ((mg, "mg", 4), (nodal, "nodal", 3)):
        fn = module.v_cycle
        if getattr(fn, "counted", False):
            continue

        def wrapped(*a, _fn=fn, _key=key, _pos=lev_pos, **k):
            if k.get("lev", a[_pos] if len(a) > _pos else 0) == 0:
                CYCLES[_key] += 1
            return _fn(*a, **k)

        wrapped.counted = True
        module.v_cycle = wrapped


def _call_sig(x):
    """What tells two calls of a kernel apart: tensor shapes and dtypes,
    emits, sweep counts and boundary codes (not float values)."""
    import torch
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), str(x.dtype))
    if isinstance(x, (tuple, list)):
        return tuple(_call_sig(i) for i in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _call_sig(v)) for k, v in x.items()))
    if isinstance(x, float):
        return "f"
    return x


def _copied(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_copied(i) for i in x)
    if isinstance(x, dict):
        return {k: _copied(v) for k, v in x.items()}
    return x


# {kind: (name, args, kwargs)}: the calls record_kernel_calls keeps
RECORDED = {}


def record_kernel_calls(names=None):
    """Make every kernel wrapper of counters() (or those named in
    ``names``) keep a copy of its inputs at its first call of each kind
    (_call_sig) from now on, until stop_recording(): the shapes a
    decomposed rank gives it. Returns RECORDED, emptied. Call it before
    counters(): the wrappers' launch helpers count on the module's name,
    which then names the recording wrapper."""
    import functools
    RECORDED.clear()
    calls = RECORDED
    for name, fn in counters().items():
        if getattr(fn, "recording", False) or (names and name not in names):
            continue

        @functools.wraps(fn)
        def rec(*a, _fn=fn, _name=name, **k):
            key = (_name, _call_sig(a), _call_sig(k))
            if key not in calls:
                calls[key] = (_name, _copied(a), _copied(k))
            return _fn(*a, **k)

        rec.recording = True
        setattr(sys.modules[fn.__module__], name, rec)
    return calls


def stop_recording():
    """Put back the wrappers that record_kernel_calls replaced, with the
    launches counted meanwhile."""
    for name, fn in counters().items():
        if getattr(fn, "recording", False):
            fn.__wrapped__.launches = fn.launches
            if hasattr(fn, "fused_launches"):
                fn.__wrapped__.fused_launches = fn.fused_launches
            setattr(sys.modules[fn.__module__], name, fn.__wrapped__)


def check_recorded(torch, calls):
    """Each recorded call run again through its kernel and through its
    plain version, each on its own copy of the recorded inputs, and held
    as phase 2 holds them (TOL_KERNEL of each output's largest value).
    Returns one row a call."""
    rows = []
    for name, a, k in calls.values():
        fn = counters()[name]
        kern = getattr(fn, "__wrapped__", fn)
        plain = getattr(sys.modules[kern.__module__],
                        name.removesuffix("_fused") + "_plain")
        tensors = [t for t in a if isinstance(t, torch.Tensor)]
        dtype_name = str(tensors[0].dtype).removeprefix("torch.")
        tol = TOL_KERNEL[dtype_name]
        out = kern(*_copied(a), **_copied(k))
        ref = plain(*_copied(a), **_copied(k))
        errs = max_errs(out, ref)
        del out, ref
        rows.append(dict(
            name=name, shape=list(tensors[0].shape), dtype=dtype_name,
            emit=k.get("emit", a[6] if name == "nodal_sweep_3d"
                       and len(a) > 6 else None),
            errs=[e for e, _ in errs], ref_max=[sc for _, sc in errs],
            ok=all(e <= tol * max(sc, 1e-30) for e, sc in errs),
            worst=max(e / (tol * max(sc, 1e-30)) for e, sc in errs)))
    return rows


def decomp_run(kw, steps, expect, out_path=None):
    """Varden on ``kw`` for ``steps`` steps on the card, decomposed over the
    ranks of the process group where there is one (mesh = its size), with
    the launch, exchange and V-cycle counters of every step. Rank 0 writes
    the gathered final state to ``out_path``. A decomposed rank records the
    first call of each kind of every kernel and, after the run, holds each
    against its plain version (check_recorded; these launches are not
    counted). Returns this rank's records."""
    import torch
    import torch.distributed as dist
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.driver import Varden
    from varden_tpu_torch.parallel import halo
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    if ranks > 1:
        torch.cuda.set_device(0)
    calls = record_kernel_calls() if ranks > 1 else None
    count_cycles()
    fns = counters()
    zero_counts(fns)
    halo.exchanges.reset()
    halo.reductions.reset()
    cfg = VardenConfig(**kw, max_step=steps, mesh=ranks if ranks > 1 else 0)
    v = Varden(cfg)  # the card: no device named

    def sync():
        torch.cuda.synchronize()
        if ranks > 1:
            dist.barrier()

    state = v.initialize()
    sync()
    per_step = []
    while v.istep < steps:
        before = read_counts(fns)
        ex0, red0 = halo.exchanges.as_dict(), halo.reductions.as_dict()
        cyc0 = dict(CYCLES)
        t0 = time.perf_counter()
        state = v.step(state)
        sync()
        sec = time.perf_counter() - t0
        d = v.last_diag
        ex, red = halo.exchanges.as_dict(), halo.reductions.as_dict()
        per_step.append(dict(
            step=v.istep, seconds=sec, dt=v.dt,
            mac_ratio=float(d["mac_ratio"]), hg_ratio=float(d["hg_ratio"]),
            visc_ratio=float(d.get("visc_ratio", 0.0)),
            visc_cycles=int(d.get("visc_cycles", 0)),
            div_before=float(d["div_before"]), div_after=float(d["div_after"]),
            rho_min=float(d["smin"]), rho_max=float(d["smax"]),
            cycles={k: CYCLES[k] - cyc0[k] for k in CYCLES},
            launches={k: c - before[k] for k, c in read_counts(fns).items()},
            exchanges={k: ex[k] - ex0[k] for k in ex},
            reductions={k: red[k] - red0[k] for k in red}))
    launches = read_counts(fns)
    g = v.gather(state)
    for key in ("u", "s", "gp", "p"):
        need(bool(torch.isfinite(getattr(g, key)).all()),
             f"field {key} is not finite")
    if out_path is not None and (ranks == 1 or dist.get_rank() == 0):
        torch.save({k: getattr(g, k).cpu() for k in ("u", "s", "gp", "p")},
                   out_path)
    block = list(v.sim.dec.n) if v.sim.dec is not None else list(cfg.n_cell)
    del g, state, v
    checks = check_recorded(torch, calls) if calls is not None else []
    return {"rank": dist.get_rank() if ranks > 1 else 0, "block": block,
            "per_step": per_step, "launches": launches,
            "exchanges": halo.exchanges.as_dict(), "kernel_checks": checks}


def field_errs(got, ref, what):
    """{field: max|got - ref| / max(1, max|ref|)}."""
    out = {}
    for k in ("u", "s", "gp", "p"):
        a, b = got[k].double(), ref[k].double().cpu()
        need(a.shape == b.shape, f"{what}: {k} shape {tuple(a.shape)} is "
             f"not {tuple(b.shape)}")
        out[k] = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
    return out


def steady_of(rec):
    """A rank's steady steps (all of them if there is only one)."""
    return rec["per_step"][1:] or rec["per_step"]


def phase_decomp(torch, kw, steps, nranks, expect, ref_fields, ref_steps,
                 tol, label, same_cycles, bubble=True, roundoff=None):
    """Phase 16's run of ``kw`` on ``nranks`` gloo ranks sharing the card,
    against the one-rank run (``ref_fields``, ``ref_steps``): the gathered
    fields within ``tol`` of their size, or (``roundoff``: the one-rank
    float32 run's distance from float64, by field) within twice that where
    it is larger; the gates of phase 4 on every step, every kernel of
    ``expect`` launched on every rank and no other, each kernel's calls
    at the ranks' shapes equal to its plain version's (decomp_run), and
    (with ``same_cycles``) the same V-cycles and viscous cycles a step."""
    import tempfile
    from varden_tpu_torch.parallel import launch
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.pt")
        t0 = time.perf_counter()
        recs = launch.spawn(decomp_run, nranks, kw, steps, expect, path,
                            timeout=DECOMP_TIMEOUT)
        wall = time.perf_counter() - t0
        got = torch.load(path)
    errs = field_errs(got, ref_fields, label)
    err = max(errs.values())
    tols = {k: max(tol, 2.0 * roundoff[k]) if roundoff else tol
            for k in errs}
    print(f"  {label}: {nranks} gloo ranks on one card, blocks "
          f"{recs[0]['block']}, fields within {errs} of their size of the "
          f"one-rank run (tolerances {tols}"
          + (f"; the one-rank float32 run is {roundoff} from float64"
             if roundoff else "") + f"), {wall:.1f} s with the ranks' "
          "start", flush=True)
    for s, ref in zip(recs[0]["per_step"], ref_steps):
        print(f"    step {s['step']}: {s['seconds']:.4f} s on {nranks} ranks "
              f"against {ref['seconds']:.4f} s on one (the cost of the "
              f"decomposition on one card, not a scaling); V-cycles "
              f"{s['cycles']} against {ref['cycles']}, viscous "
              f"{s['visc_cycles']} against {ref['visc_cycles']}", flush=True)
    for rec in recs:
        for s in steady_of(rec):
            print(f"    rank {rec['rank']} step {s['step']}: halo exchanges "
                  f"{s['exchanges']['count']} ({s['exchanges']['bytes']} "
                  f"bytes sent, {s['exchanges']['seconds']:.4f} s), "
                  f"reductions {s['reductions']['count']} "
                  f"({s['reductions']['seconds']:.4f} s); launches "
                  f"{ {k: c for k, c in s['launches'].items() if c} }",
                  flush=True)
    checks = [dict(c, rank=rec["rank"]) for rec in recs
              for c in rec["kernel_checks"]]
    for name in sorted({c["name"] for c in checks}):
        mine = [c for c in checks if c["name"] == name]
        shapes = sorted({tuple(c["shape"]) for c in mine})
        worst = max(c["worst"] for c in mine)
        print(f"    {name} against its plain version at the ranks' inputs: "
              f"{len(mine)} calls, largest error {worst:.3e} of its "
              f"tolerance (TOL_KERNEL x max|ref|), emits "
              f"{sorted({str(c['emit']) for c in mine})}, shapes {shapes}",
              flush=True)
    bad = [c for c in checks if not c["ok"]]
    need(not bad, f"{label}: kernels disagree with their plain versions at "
         f"the ranks' inputs: {bad[:4]}")
    need(all(errs[k] <= tols[k] for k in errs),
         f"{label}: the fields differ from the one-rank run by {errs} of "
         f"their size (tolerances {tols})")
    rho_hi = 10.0 if len(got["u"].shape) == 4 else 2.0
    tol_rho = TOL_RHO_VISCOUS if kw.get("visc_coef", 0.0) > 0.0 else TOL_RHO
    for rec in recs:
        recorded = {c["name"] for c in rec["kernel_checks"]}
        for k, c in rec["launches"].items():
            base = k.split(":")[0]
            if base not in expect:
                need(c == 0, f"{label}: {k} is not on this path but rank "
                     f"{rec['rank']} launched it {c}x")
            elif k == base:
                need(c > 0 and k in recorded,
                     f"{label}: rank {rec['rank']} did not launch {k}, or "
                     "did not hold it to its plain version")
        need(rec["exchanges"]["count"] > 0,
             f"{label}: rank {rec['rank']} exchanged no halo")
    for s, ref in zip(recs[0]["per_step"], ref_steps):
        need(s["mac_ratio"] <= 1.0 and s["hg_ratio"] <= 1.0
             and s["visc_ratio"] <= 1.0,
             f"{label} step {s['step']}: a solve stopped above its "
             f"tolerance ({s['mac_ratio']}, {s['hg_ratio']}, "
             f"{s['visc_ratio']})")
        need(s["div_after"] < s["div_before"],
             f"{label} step {s['step']}: the MAC projection did not reduce "
             "div")
        need(not bubble or (1.0 - tol_rho <= s["rho_min"]
                            and s["rho_max"] <= rho_hi + tol_rho),
             f"{label} step {s['step']}: density left [1, {rho_hi}]")
        if same_cycles:
            need(s["cycles"] == ref["cycles"]
                 and s["visc_cycles"] == ref["visc_cycles"],
                 f"{label} step {s['step']}: V-cycles {s['cycles']} "
                 f"(viscous {s['visc_cycles']}) against the one-rank run's "
                 f"{ref['cycles']} ({ref['visc_cycles']})")
    for rec in recs:
        rec.pop("kernel_checks")
    return {"label": label, "ranks": nranks, "max_rel_err": err,
            "rel_errs": errs, "tolerances": tols,
            "wall_s": wall, "records": recs, "kernel_checks": checks,
            "one_rank_steps": [{k: r[k] for k in ("step", "seconds", "cycles",
                                                 "visc_cycles")}
                               for r in ref_steps]}


def phase_decomposed(torch, keys):
    """Phase 16 on the cells ``keys`` of decomp_cells(): each cell's
    one-rank run on the card (in float64 too for a float32 cell), then its
    decomposed runs against them (phase_decomp), float64 first. Returns
    their results."""
    import tempfile
    cells = decomp_cells()
    out = []
    for key in keys:
        cell = cells[key]
        kw, steps, expect = cell["kw"], cell["steps"], cell["expect"]
        dtypes = ("float64",) + (("float32",) if kw["dtype"] == "float32"
                                 else ())
        one = {}
        for dt in dtypes:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "state.pt")
                rec = decomp_run(dict(kw, dtype=dt), steps, expect, path)
                one[dt] = (torch.load(path), rec["per_step"])
            torch.cuda.empty_cache()
        roundoff = None
        if cell.get("widen"):
            roundoff = field_errs(one["float32"][0], one["float64"][0],
                                  "float64 run")
        for dt in dtypes:
            f64 = dt == "float64"
            for nr in cell["ranks"]:
                out.append(phase_decomp(
                    torch, dict(kw, dtype=dt), steps, nr, expect, *one[dt],
                    TOL_DECOMP_F64 if f64 else TOL_DECOMP_F32,
                    f"{cell['label']} {dt}", f64,
                    bubble=cell.get("bubble", True),
                    roundoff=None if f64 else roundoff))
                torch.cuda.empty_cache()
        del one
    return out


# ---------------------------------------------------------------------------
# phase 17: AMR under a mesh, every patch of every level decomposed over
# gloo ranks sharing the card
# ---------------------------------------------------------------------------

N_AMR_DECOMP = 64
AMR_DECOMP_TIMEOUT = 900.0
# the RT inputs' decomposed I/O run: to step 2 with a checkpoint every
# step and a restart from step 1 (cuts of depth from phase 15's 20 and 10,
# and from 4 and 2 to leave room for phase 19: on 4 gloo ranks of one card
# a step takes 10-14 s, and chip_smoke.py must stay inside its time limit)
RT_IO_DECOMP_STEPS = 2
RT_IO_DECOMP_CHK = 1


def amr_decomp_cells():
    """Phase 17's cells by key: the configuration (a keyword dict, or the
    inputs file and its overrides), its steps (config 5 at 64^3 and at
    256^3: 1, cut for time; config 3: through its regrid at step 5), the
    rank counts it runs on, the kernels its path launches, its label,
    whether its float32 gate widens as phase 16's 2-D cell's does, and
    whether it writes plotfiles and checkpoints and restarts (``io``).
    Each is held to its one-rank run at the same mesh."""
    return {
        "cfg5": dict(kw=cfg5_kw(N_AMR_DECOMP, "float64"), steps=1,
                     ranks=(2, 4), expect=KERNELS_AMR,
                     label=f"config 5 {N_AMR_DECOMP}^3 + 2 levels"),
        "cfg5-full": dict(kw=cfg5_kw(256, "float32"), steps=1,
                          ranks=(4,), expect=KERNELS_AMR, widen=True,
                          label="config 5 256^3 + 2 levels"),
        "cfg3": dict(kw=cfg3_kw("float64"), steps=5, ranks=(4,),
                     expect=KERNELS_2D, regrid=True,
                     label="config 3 64^2 + 1 level"),
        "rt-io": dict(inputs=os.path.join(HERE, "inputs",
                                          "inputs_RayleighTaylor_3d"),
                      kw=dict(max_step=RT_IO_DECOMP_STEPS,
                              chk_int=RT_IO_DECOMP_CHK),
                      steps=RT_IO_DECOMP_STEPS, ranks=(4,),
                      expect=KERNELS_RT_AMR,
                      io=True, regrid=True,
                      label="RT inputs (32^3 + 1 level, regrid every step)"),
    }


def _amr_cfg(cell, mesh, dtype_name=None, **over):
    from varden_tpu_torch.config import VardenConfig, load_config
    kw = dict(cell["kw"], mesh=mesh, **over)
    if dtype_name:
        kw["dtype"] = dtype_name
    if "inputs" in cell:
        return load_config(cell["inputs"], **kw)
    return VardenConfig(**dict(kw, max_step=cell["steps"]))


def _amr_levels_np(v, states):
    """The whole patches on the host."""
    return [{k: t.cpu() for k, t in (("u", s.u), ("s", s.s), ("gp", s.gp),
                                     ("p", s.p))} for s in v.gather(states)]


class _WritesBy:
    """Record the files and directories this process creates."""

    def __enter__(self):
        import builtins
        self.seen, self._open, self._mk = [], builtins.open, os.makedirs

        def spy_open(f, mode="r", *a, **k):
            if any(c in mode for c in "wax+"):
                self.seen.append(str(f))
            return self._open(f, mode, *a, **k)

        def spy_mk(p, *a, **k):
            self.seen.append(str(p))
            return self._mk(p, *a, **k)

        builtins.open, os.makedirs = spy_open, spy_mk
        return self

    def __exit__(self, *exc):
        import builtins
        builtins.open, os.makedirs = self._open, self._mk


def decomp_run_ml(cell, mesh, dtype_name=None, ref_path=None, out_path=None,
                  io_dir=None):
    """The multi-level Varden of ``cell`` at ``mesh`` on the card,
    decomposed over the process group's ranks where there is one (one rank:
    unsharded, the regridder's patches quantised to the mesh), with the
    launch, exchange, copy and V-cycle counters of every step. One rank
    saves the whole patches and its records to ``out_path``; decomposed
    ranks hold their blocks against the one-rank run's (``ref_path``) and
    record the first call of each kind of every kernel, held against its
    plain version after the run (check_recorded). With ``io_dir`` the run
    writes its plotfiles and checkpoints there and restarts on the same
    ranks from the mid-run checkpoint. Returns this rank's records."""
    import torch
    import torch.distributed as dist
    from varden_tpu_torch.driver import Varden
    from varden_tpu_torch.parallel import halo
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if ranks > 1 else 0
    if ranks > 1:
        torch.cuda.set_device(0)
    calls = record_kernel_calls() if ranks > 1 else None
    count_cycles()
    fns = counters()
    zero_counts(fns)
    for c in (halo.exchanges, halo.reductions, halo.copies):
        c.reset()
    over = {}
    if io_dir is not None:
        over = dict(plot_base_name=os.path.join(io_dir, "full", "plt"),
                    check_base_name=os.path.join(io_dir, "full", "chk"))
    cfg = _amr_cfg(cell, mesh, dtype_name, **over)
    with _WritesBy() as spy:
        v = Varden(cfg)  # the card: no device named

        def sync():
            torch.cuda.synchronize()
            if ranks > 1:
                dist.barrier()

        def write(final=False):
            """run_ml's writes (varden.f90:378)."""
            from varden_tpu_torch.io import output
            if io_dir is None:
                return
            if v._due(cfg.plot_int, final):
                output.write_plotfile_ml(v.geom, states, v.istep, v.time)
            if v._due(cfg.chk_int, final):
                output.write_checkpoint_ml(v.geom, states, v.istep, v.time,
                                           v.dt, hints=v._ml_hints)

        t0 = time.perf_counter()
        states = v.initialize_ml()
        write()
        sync()
        t_init = time.perf_counter() - t0
        per_step = []
        while v._running(cfg.max_step):
            before = read_counts(fns)
            cnt0 = {c: getattr(halo, c).as_dict()
                    for c in ("exchanges", "reductions", "copies")}
            cyc0, regrids = dict(CYCLES), v.regrids
            t0 = time.perf_counter()
            states = v.step_ml(states)
            write(final=not v._running(cfg.max_step))
            sync()
            sec = time.perf_counter() - t0
            d = v.last_diag
            rec = dict(step=v.istep, seconds=sec, dt=v.dt,
                       key=v.geom.key(), regrid=v.regrids > regrids,
                       mac_ratio=float(d["mac_ratio"]),
                       hg_ratio=float(d["hg_ratio"]),
                       visc_ratio=float(d.get("visc_ratio", 0.0)),
                       mac_outer=int(d["mac_outer"]),
                       hg_outer=int(d["hg_outer"]),
                       visc_outer=[int(k) for k in d.get("visc_outer", [])],
                       div_before=float(d["div_before"]),
                       div_after=float(d["div_after"]),
                       cycles={k: CYCLES[k] - cyc0[k] for k in CYCLES},
                       launches={k: c - before[k]
                                 for k, c in read_counts(fns).items()})
            for c in ("exchanges", "reductions", "copies"):
                now = getattr(halo, c).as_dict()
                rec[c] = {k: now[k] - cnt0[c][k] for k in now}
            per_step.append(rec)
    launches = read_counts(fns)
    others_wrote = spy.seen if rank else []
    for st in states:
        for key in ("u", "s", "gp", "p"):
            need(bool(torch.isfinite(getattr(st, key)).all()),
                 f"rank {rank}: field {key} is not finite")
    out = {"rank": rank, "per_step": per_step, "launches": launches,
           "init_s": t_init, "key": v.geom.key(),
           "blocks": [list(v.geom.bn(l)) for l in range(v.geom.nlev)],
           "others_wrote": others_wrote}
    if ref_path is not None:
        ref = torch.load(ref_path)
        need(ref["key"] == v.geom.key(), f"rank {rank}: the hierarchy "
             f"{v.geom.key()} is not the one-rank run's {ref['key']}")
        errs = {}
        for lev, (st, r) in enumerate(zip(states, ref["states"])):
            for k in ("u", "s", "gp", "p"):
                whole = r[k].to(getattr(st, k).device, torch.float64)
                mine = getattr(st, k).double()
                blk = v.geom.block(lev, whole, k == "p")
                err = float((mine - blk).abs().max()) / max(
                    1.0, float(whole.abs().max()))
                errs[k] = max(errs.get(k, 0.0), err)
        if ranks > 1:
            e = halo.all_max(torch.tensor([errs[k] for k in
                                           ("u", "s", "gp", "p")],
                                          dtype=torch.float64,
                                          device=states[0].u.device))
            errs = dict(zip(("u", "s", "gp", "p"), e.tolist()))
        out["rel_errs"] = errs
        del ref
    if io_dir is not None:
        out["io"] = _amr_io_restart(v, cell, mesh, io_dir, states, ranks)
        need(ranks == 1 or out["io"]["same"], f"rank {rank}: the restart "
             f"from chk{cell['kw']['chk_int']:05d} does not equal the "
             "uninterrupted run bit for bit")
    if out_path is not None:  # the one-rank run
        torch.save({"key": v.geom.key(), "per_step": per_step,
                    "states": _amr_levels_np(v, states)}, out_path)
    del states, v
    torch.cuda.empty_cache()
    out["kernel_checks"] = (check_recorded(torch, calls)
                            if calls is not None else [])
    return out


def _amr_io_restart(v, cell, mesh, io_dir, states, ranks):
    """Read back every plotfile and checkpoint the run wrote (finite, its
    boxes), and (decomposed) restart from the mid-run checkpoint on the
    same ranks: ``same`` says whether the final patches equal the
    uninterrupted run's bit for bit on every rank."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    from varden_tpu_torch.driver import Varden
    from varden_tpu_torch.io import boxlib
    full, again = os.path.join(io_dir, "full"), os.path.join(io_dir, "again")
    chk = cell["kw"]["chk_int"]
    rank = dist.get_rank() if ranks > 1 else 0
    boxes = {}
    if rank == 0:
        for d in sorted(os.listdir(full)):
            if d.startswith("plt"):
                _n, _t, levels = boxlib.read_plotfile(os.path.join(full, d))
                need(all(bool(np.isfinite(a).all()) for a in levels),
                     f"{d} did not read back finite")
                boxes[d] = [list(a.shape[1:]) for a in levels]
            for root, dirs, _f in os.walk(os.path.join(full, d)):
                for sub in dirs:
                    if sub.startswith("Level_"):
                        bx, _nodal = boxlib.read_multifab_boxes(
                            os.path.join(root, sub))
                        need(all(bool(np.isfinite(a).all()) for a, _ in bx),
                             f"{d}/{sub} did not read back finite")
                        boxes.setdefault(d + "/" + os.path.relpath(
                            os.path.join(root, sub), os.path.join(full, d)),
                            [[list(lo), list(a.shape)] for a, lo in bx])
        shutil.copytree(os.path.join(full, f"chk{chk:05d}"),
                        os.path.join(again, f"chk{chk:05d}"))
    files = sorted(os.listdir(full)) if rank == 0 else None
    if ranks == 1:
        return {"boxes": boxes, "files": files}
    dist.barrier()
    t0 = time.perf_counter()
    cfg = _amr_cfg(cell, mesh, restart=chk,
                   plot_base_name=os.path.join(again, "plt"),
                   check_base_name=os.path.join(again, "chk"))
    v2 = Varden(cfg)
    st2 = v2.run()
    torch.cuda.synchronize()
    t_restart = time.perf_counter() - t0
    same = (v2.istep == v.istep and v2.time == v.time
            and v2.geom.key() == v.geom.key()
            and all(torch.equal(getattr(a, k), getattr(b, k))
                    for a, b in zip(states, st2) for k in ("u", "s", "gp",
                                                          "p")))
    from varden_tpu_torch.parallel import halo
    same = bool(halo.all_min(torch.tensor(float(same),
                                          device=states[0].u.device)) == 1.0)
    return {"boxes": boxes, "restart_s": t_restart, "files": files,
            "same": same}


def phase_decomp_amr(torch, cell, nranks, ref, dtype_name, tol, same_cycles,
                     roundoff=None, io_dir=None):
    """Phase 17's run of ``cell`` on ``nranks`` gloo ranks sharing the
    card against its one-rank run at the same mesh (``ref``: its saved
    file and records): the hierarchy of every step equal, each field of
    every patch within ``tol`` of its size (or, with ``roundoff``, twice
    the one-rank float32 run's distance from float64 where that is
    larger), every kernel of the path launched on every rank and held to
    its plain version at the ranks' inputs, and (``same_cycles``) equal
    V-cycle and outer counts."""
    from varden_tpu_torch.parallel import launch
    label = f"{cell['label']} {dtype_name}"
    t0 = time.perf_counter()
    recs = launch.spawn(decomp_run_ml, nranks, cell, nranks, dtype_name,
                        ref["path"], None, io_dir,
                        timeout=AMR_DECOMP_TIMEOUT)
    wall = time.perf_counter() - t0
    errs = recs[0]["rel_errs"]
    tols = {k: max(tol, 2.0 * roundoff[k]) if roundoff else tol
            for k in errs}
    print(f"  {label}: {nranks} gloo ranks on one card, fields within "
          f"{errs} of their size of the one-rank run at mesh {nranks} "
          f"(tolerances {tols}), {wall:.1f} s with the ranks' start; "
          f"blocks of rank 0 {recs[0]['blocks']}", flush=True)
    for s, r in zip(recs[0]["per_step"], ref["per_step"]):
        print(f"    step {s['step']}{' (regrid)' if s['regrid'] else ''}: "
              f"{s['seconds']:.4f} s on {nranks} ranks against "
              f"{r['seconds']:.4f} s on one (the cost of the decomposition "
              f"on one card, not a scaling); outer MAC {s['mac_outer']} HG "
              f"{s['hg_outer']} visc {s['visc_outer']} against "
              f"{r['mac_outer']} {r['hg_outer']} {r['visc_outer']}; "
              f"V-cycles {s['cycles']} against {r['cycles']}", flush=True)
    for rec in recs:
        for s in steady_of(rec):
            ex, cp = s["exchanges"], s["copies"]
            print(f"    rank {rec['rank']} step {s['step']}: halo exchanges "
                  f"{ex['count']} ({ex['bytes']} bytes sent, "
                  f"{ex['seconds']:.4f} s); fetch/put {cp['count']} calls, "
                  f"{cp['elements']} elements received, {cp['bytes']} bytes "
                  f"sent, {cp['seconds']:.4f} s; reductions "
                  f"{s['reductions']['count']} "
                  f"({s['reductions']['seconds']:.4f} s); launches "
                  f"{ {k: c for k, c in s['launches'].items() if c} }",
                  flush=True)
    checks = [dict(c, rank=rec["rank"]) for rec in recs
              for c in rec["kernel_checks"]]
    for name in sorted({c["name"] for c in checks}):
        mine = [c for c in checks if c["name"] == name]
        print(f"    {name} against its plain version at the ranks' inputs: "
              f"{len(mine)} calls, largest error "
              f"{max(c['worst'] for c in mine):.3e} of its tolerance, "
              f"shapes {sorted({tuple(c['shape']) for c in mine})}",
              flush=True)
    bad = [c for c in checks if not c["ok"]]
    need(not bad, f"{label}: kernels disagree with their plain versions at "
         f"the ranks' inputs: {bad[:4]}")
    expect = cell["expect"]
    for rec in recs:
        need(not rec["others_wrote"], f"{label}: rank {rec['rank']} wrote "
             f"{rec['others_wrote'][:4]}")
        recorded = {c["name"] for c in rec["kernel_checks"]}
        for k, c in rec["launches"].items():
            base = k.split(":")[0]
            if base not in expect:
                need(c == 0, f"{label}: {k} is not on this path but rank "
                     f"{rec['rank']} launched it {c}x")
            elif k == base:
                need(c > 0 and k in recorded,
                     f"{label}: rank {rec['rank']} did not launch {k}, or "
                     "did not hold it to its plain version")
        need(rec["per_step"] and all(
            s["copies"]["count"] > 0 for s in rec["per_step"]),
            f"{label}: rank {rec['rank']} made no coarse-fine copy")
    need([s["key"] for s in recs[0]["per_step"]]
         == [r["key"] for r in ref["per_step"]],
         f"{label}: the hierarchies differ from the one-rank run's")
    need(not cell.get("regrid") or any(s["regrid"] for s in
                                       recs[0]["per_step"]),
         f"{label}: no regrid happened")
    need(all(errs[k] <= tols[k] for k in errs),
         f"{label}: the fields differ from the one-rank run by {errs} of "
         f"their size (tolerances {tols})")
    for s, r in zip(recs[0]["per_step"], ref["per_step"]):
        need(max(s["mac_ratio"], s["hg_ratio"], s["visc_ratio"]) <= 1.0,
             f"{label} step {s['step']}: a solve stopped above its "
             "tolerance")
        need(s["div_after"] < s["div_before"],
             f"{label} step {s['step']}: the MAC projection did not reduce "
             "div")
        if same_cycles:
            need(all(s[k] == r[k] for k in ("cycles", "mac_outer",
                                             "hg_outer", "visc_outer")),
                 f"{label} step {s['step']}: cycles {s['cycles']} outer "
                 f"{s['mac_outer']} {s['hg_outer']} {s['visc_outer']} "
                 f"against {r['cycles']} {r['mac_outer']} {r['hg_outer']} "
                 f"{r['visc_outer']}")
    io = recs[0].get("io")
    if io is not None:
        need(io["boxes"] == ref["io"]["boxes"], f"{label}: the plotfiles' "
             "and checkpoints' boxes differ from the one-rank run's")
        print(f"    only rank 0 wrote: {io['files']}, every plotfile and "
              f"checkpoint finite with the one-rank run's boxes; restart "
              f"from chk{cell['kw']['chk_int']:05d} on {nranks} ranks "
              "bitwise equal to "
              f"the uninterrupted run ({io['restart_s']:.1f} s)", flush=True)
    for rec in recs:
        rec.pop("kernel_checks")
    return {"label": label, "ranks": nranks, "rel_errs": errs,
            "max_rel_err": max(errs.values()), "tolerances": tols,
            "wall_s": wall, "records": recs, "kernel_checks": checks,
            "one_rank_steps": [{k: r[k] for k in ("step", "seconds",
                                                 "cycles", "mac_outer",
                                                 "hg_outer")}
                               for r in ref["per_step"]]}


def _amr_reference(torch, cell, mesh, dtype_name, tmp, io=False):
    """The one-rank run of ``cell`` at ``mesh`` (unsharded), saved."""
    import warnings
    path = os.path.join(tmp, f"ref-{mesh}-{dtype_name}.pt")
    io_dir = os.path.join(tmp, f"io-one-{mesh}") if io else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec = decomp_run_ml(cell, mesh, dtype_name, None, path, io_dir)
    torch.cuda.empty_cache()
    saved = torch.load(path)
    return {"path": path, "per_step": saved["per_step"],
            "states": saved["states"], "io": rec.get("io")}


def phase_decomposed_amr(torch, keys):
    """Phase 17 on the cells ``keys`` of amr_decomp_cells(): for each rank
    count the cell's one-rank run at that mesh, then its decomposed run
    against it (phase_decomp_amr). A float32 cell whose gate fails widens
    it as phase 16's 2-D cell does: to twice the one-rank float32 run's
    distance from float64, after the float64 run on the same ranks meets
    the float64 gate with equal cycles."""
    import shutil
    import tempfile
    cells = amr_decomp_cells()
    out = []
    for key in keys:
        cell = cells[key]
        dtype_name = cell["kw"].get("dtype", "float64")
        f64 = dtype_name == "float64"
        for nr in cell["ranks"]:
            tmp = tempfile.mkdtemp(prefix="chip_smoke_amr_")
            try:
                ref = _amr_reference(torch, cell, nr, dtype_name, tmp,
                                     io=cell.get("io", False))
                io_dir = (os.path.join(tmp, "io-dec") if cell.get("io")
                          else None)
                try:
                    out.append(phase_decomp_amr(
                        torch, cell, nr, ref, dtype_name,
                        TOL_DECOMP_F64 if f64 else TOL_DECOMP_F32, f64,
                        io_dir=io_dir))
                except PhaseError as e:
                    if f64 or not cell.get("widen"):
                        raise
                    print(f"  {cell['label']} float32: {e}; the float64 "
                          "runs decide whether the gate widens", flush=True)
                    ref64 = _amr_reference(torch, cell, nr, "float64", tmp)
                    out.append(phase_decomp_amr(
                        torch, cell, nr, ref64, "float64", TOL_DECOMP_F64,
                        True))
                    roundoff = field_errs_ml(ref["states"], ref64["states"])
                    out.append(phase_decomp_amr(
                        torch, cell, nr, ref, dtype_name, TOL_DECOMP_F32,
                        False, roundoff=roundoff))
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 18: the tail, profiling.profile_phases / profile_phases_ml and the
# Godunov debug oracle (use_godunov_debug) on the card
# ---------------------------------------------------------------------------

# the kernels of profile_phases' four phases in 3-D (premac: kernel 1; mac:
# kernel 3's fused stages; scalar: kernel 11, then kernel 6; hg: kernel
# 4's), in 2-D (kernels 9, 8, 10), and of profile_phases_ml's three phases
# on a 3-D hierarchy (kernel 1 on every level, the composite solves'
# kernels 3 and 4)
KERNELS_TAIL = ("velpred_3d_fused", "mkflux_3d_fused", "update_3d",
                "gsrb_var_sweep_3d", "nodal_sweep_3d")
KERNELS_TAIL_ML = ("velpred_3d_fused", "gsrb_var_sweep_3d", "nodal_sweep_3d")
# timed calls of each phase (after the one warm-up call; the phases' first
# calls make the next phase's inputs): a cut of depth, the reference takes 3
TAIL_REPS = 2


def phase_profile(torch, kw, expect, off, record=()):
    """profiling.profile_phases (or, with max_levs > 1, profile_phases_ml)
    on the configuration ``kw`` after its initialization, on the card,
    with every launch counter zeroed just before and read just after: the
    kernels of ``expect`` launched, those of ``off`` not. The kernels of
    ``record``
    keep their first call of each kind, each then held against its plain
    version (check_recorded). Returns the phases' seconds, the launches
    and the recorded calls' rows."""
    from varden_tpu_torch import profiling
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.driver import Varden
    v = Varden(VardenConfig(**kw))
    t0 = time.perf_counter()
    states = v.initialize_ml() if v.ml else v.initialize()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    calls = record_kernel_calls(record) if record else None
    fns = counters()
    zero_counts(fns)
    try:
        if v.ml:
            phases = profiling.profile_phases_ml(v.geom, states, v.dt,
                                                 TAIL_REPS)
        else:
            phases = profiling.profile_phases(v.sim, states, v.dt, TAIL_REPS)
        torch.cuda.synchronize()
        launches = read_counts(fns)
    finally:
        if record:
            stop_recording()
    print(f"  initialization {t_init:.3f} s; launches "
          f"{ {k: c for k, c in launches.items() if c} }", flush=True)
    for k in expect:
        need(launches[k] > 0, f"{k} did not launch on the profiled phases")
    for k in off:
        need(launches[k] == 0, f"{k} launched {launches[k]}x on the "
                               f"profiled phases")
    rows = check_recorded(torch, calls) if record else []
    for r in rows:
        print(f"  recorded {r['name']} {r['shape']} {r['dtype']}: errs "
              f"{[f'{e:.3e}' for e in r['errs']]}, worst "
              f"{r['worst']:.3e} of TOL_KERNEL", flush=True)
        need(r["ok"], f"{r['name']} at {r['shape']} on the profiled phases "
                      f"disagrees with its plain version: {r['errs']}")
    need(not record or {r["name"] for r in rows} == set(record),
         f"phase 18: recorded {[r['name'] for r in rows]}, not {record}")
    del v, states
    torch.cuda.empty_cache()
    return {"phases": phases, "launches": launches, "init_s": t_init,
            "kernel_checks": rows}


def phase_debug(torch, kw, steps, expect_on, expect_off):
    """Varden.run of ``kw`` (float64) for ``steps`` steps on the card with
    use_godunov_debug and without, launches counted in the flagged run:
    the kernels of ``expect_on`` launched, those of ``expect_off`` not;
    every field of every level within TOL_STEP of its size of the run
    without the flag (in the oracle's role the two forms compute the same
    thing)."""
    from varden_tpu_torch.config import VardenConfig
    from varden_tpu_torch.driver import Varden
    out = {}
    fns = counters()
    for flag in (True, False):
        zero_counts(fns)
        t0 = time.perf_counter()
        v = Varden(VardenConfig(**kw, max_step=steps,
                                use_godunov_debug=flag))
        states = v.run()
        torch.cuda.synchronize()
        out[flag] = (states if v.ml else [states], read_counts(fns),
                     time.perf_counter() - t0)
        del v
    (dbg, launches, t_dbg), (ref, _, t_ref) = out[True], out[False]
    for k in expect_on:
        need(launches[k] > 0, f"{k} did not launch on the debug run")
    for k in expect_off:
        need(launches[k] == 0, f"{k} launched {launches[k]}x on the debug "
                               f"run")
    need(len(dbg) == len(ref), "the debug run built another hierarchy")
    worst = 0.0
    for a, b in zip(dbg, ref):
        for key in ("u", "s", "gp", "p"):
            x, y = getattr(b, key), getattr(a, key)
            need(x.shape == y.shape, f"debug run {key}: shape {y.shape}")
            need(bool(torch.isfinite(y).all()), f"debug run {key} not finite")
            err = float((x - y).abs().max()) / max(1.0,
                                                   float(x.abs().max()))
            worst = max(worst, err)
            need(err <= TOL_STEP, f"debug run field {key} differs from the "
                                  f"run without the flag by {err} of its size")
    print(f"  {steps} steps float64, {len(dbg)} level(s): within "
          f"{worst:.3e} of the run without the flag (tol {TOL_STEP:.0e}); "
          f"wall {t_dbg:.3f} s against {t_ref:.3f} s; launches "
          f"{ {k: c for k, c in launches.items() if c} }", flush=True)
    return {"max_rel_err": worst, "launches": launches, "debug_s": t_dbg,
            "plain_s": t_ref}


def phase_tail(torch):
    """Phase 18: profile_phases on the headline (kernels 11 and 6 recorded
    and held to their plain versions) and on config 2's geometry at
    N_2D^2, profile_phases_ml on config 5 at 256^3 + 2 levels (each phase
    TAIL_REPS timed calls after a warm-up), then the debug oracle on the
    card in float64 against the same runs without it."""
    out = {}
    print(f"  profile_phases, the headline 256^3 float32:", flush=True)
    out["headline"] = phase_profile(
        torch, bubble_kw(256, "float32", visc_coef=1.0e-3), KERNELS_TAIL,
        ("mkflux_update_3d_fused",) + KERNELS_2D,
        record=("mkflux_3d_fused", "update_3d"))
    ln = out["headline"]["launches"]
    need(ln["mkflux_3d_fused"] == 2 * ln["update_3d"],
         f"kernel 11 launched {ln['mkflux_3d_fused']}x for "
         f"{ln['update_3d']} scalar phase call(s), not 2 a call")
    print(f"  profile_phases, config 2's geometry {N_2D}^2 float32:",
          flush=True)
    out["2d"] = phase_profile(
        torch, bubble2d_kw(N_2D, "float32", visc_coef=VISC_2D), KERNELS_2D,
        KERNELS_3D + OFF_PATH)
    print("  profile_phases_ml, config 5 256^3 + 2 levels float32:",
          flush=True)
    out["cfg5"] = phase_profile(
        torch, cfg5_kw(256, "float32"), KERNELS_TAIL_ML,
        ("mkflux_update_3d_fused",) + OFF_PATH + KERNELS_2D)
    print("  use_godunov_debug on the card, float64:", flush=True)
    out["debug"] = {
        "bubble32": phase_debug(
            torch, bubble_kw(32, "float64", visc_coef=1.0e-3), STEPS_SHORT,
            ("update_3d", "gsrb_const_sweep_3d"),
            ("velpred_3d_fused", "mkflux_update_3d_fused",
             "mkflux_3d_fused")),
        "bubble2d_64": phase_debug(
            torch, bubble2d_kw(64, "float64"), STEPS_SHORT,
            ("gsrb_sweep_2d",), ("velpred_2d_fused", "mkflux_2d_fused")),
        "cfg5_32": phase_debug(
            torch, cfg5_kw(32, "float64"), STEPS_SHORT,
            ("velpred_3d_fused", "mkflux_3d_fused", "update_3d"),
            ("mkflux_update_3d_fused",))}
    return out


# ---------------------------------------------------------------------------
# phase 19: the regression suite on the card
# ---------------------------------------------------------------------------
# the kernels each workload of varden_tpu_torch.regression launches with its
# shipped options: every 3-D workload is viscous (kernel 5); MAC levels with
# walls in x take kernel 3, periodic ones kernel 7's fused stages
KERNELS_PERIODIC_X = ("velpred_3d_fused", "mkflux_update_3d_fused",
                      "nodal_sweep_3d", "gsrb_const_sweep_3d",
                      "gsrb_sweep_3d")
REGRESSION_KERNELS = {
    "bubble-2d": KERNELS_2D, "bubble-3d": KERNELS_3D,
    "bubble-restart": KERNELS_3D, "advect-2d": KERNELS_2D,
    "advect-3d": KERNELS_3D, "rt-2d": KERNELS_2D,
    "rt-3d": KERNELS_PERIODIC_X, "vortex-3d": KERNELS_PERIODIC_X}
# the check that fails in varden_tpu's harness as in the port (ROADMAP.md
# section 3): run_regression.py holds the 3-D advected bubble, whose density
# starts at up to densfact 10 in 3-D (initdata), to [1, 2]; the card must
# give the failure the CPU gives
REGRESSION_REFERENCE_FAILS = {"advect-3d": "level 0 rho overshoot"}
# the steps of each workload's quick config held card against CPU (and, in
# 2-D, float32 against float64); the regular step whose kernel calls are
# recorded and held to their plain versions
REGRESSION_CHECK_STEPS = 2
REGRESSION_RECORD_STEP = 2


class StepLaunches:
    """For the duration of a with block, the launches of every regular step
    of every Varden (Varden.step, step_ml) into ``per_step``, and the
    kernel calls (record_kernel_calls) of the first step numbered
    ``record_step`` into ``calls``."""

    def __init__(self, record_step):
        self.record_step = record_step
        self.per_step = []
        self.calls = None

    def __enter__(self):
        from varden_tpu_torch.driver import Varden
        self._orig = (Varden.step, Varden.step_ml)
        fns = counters()

        def counted(orig):
            def step(v, *a, **k):
                rec = self.calls is None and v.istep + 1 == self.record_step
                before = read_counts(fns)
                calls = record_kernel_calls() if rec else None
                try:
                    out = orig(v, *a, **k)
                finally:
                    if rec:
                        stop_recording()
                        self.calls = dict(calls)
                self.per_step.append({n: c - before[n]
                                      for n, c in read_counts(fns).items()})
                return out
            return step

        Varden.step, Varden.step_ml = (counted(f) for f in self._orig)
        return self

    def __exit__(self, *exc):
        from varden_tpu_torch.driver import Varden
        Varden.step, Varden.step_ml = self._orig
        return False


def step_extrema(torch, cfg):
    """Varden on ``cfg`` on the card for cfg.max_step steps: each step's
    density extrema and max|u| over every level."""
    from varden_tpu_torch.driver import Varden
    v = Varden(cfg)
    states = v.initialize_ml() if v.ml else v.initialize()
    out = []
    while v.istep < cfg.max_step:
        states = v.step_ml(states) if v.ml else v.step(states)
        lv = states if v.ml else [states]
        out.append(dict(step=v.istep,
                        rho_min=min(float(st.s[0].min()) for st in lv),
                        rho_max=max(float(st.s[0].max()) for st in lv),
                        umax=max(float(st.u.abs().max()) for st in lv)))
    return out


def phase_regression_workload(torch, name):
    """One quick workload of varden_tpu_torch.regression on the card as
    shipped (float64), launches counted a step: its checks pass (or fail
    as REGRESSION_REFERENCE_FAILS says), its kernels launched and kernels
    6 and 11 not, and the kernel calls of step REGRESSION_RECORD_STEP held
    to their plain versions."""
    from varden_tpu_torch import regression
    fns = counters()
    zero_counts(fns)
    failed, res = None, {}
    with StepLaunches(REGRESSION_RECORD_STEP) as sl:
        t0 = time.perf_counter()
        try:
            res = regression.run_workload(name)  # the card: no device named
        except regression.CheckFailed as e:
            failed, res = str(e), e.numbers
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts(fns)
    known = REGRESSION_REFERENCE_FAILS.get(name)
    if known is None:
        need(failed is None, f"regression {name} failed on the card: "
                             f"{failed}")
    else:
        need(failed is not None and failed.startswith(known),
             f"regression {name}: the reference harness's failure "
             f"{known!r} expected, got {failed!r}")
    expect = REGRESSION_KERNELS[name]
    other = (KERNELS_2D if expect is not KERNELS_2D
             else KERNELS_3D + ("gsrb_sweep_3d",))
    for k in expect:
        need(launches[k] > 0, f"regression {name}: {k} did not launch")
    for k in OFF_PATH + other:
        need(launches[k] == 0, f"regression {name}: {k} launched "
                               f"{launches[k]}x")
    need(sl.calls is not None, f"regression {name}: step "
                               f"{REGRESSION_RECORD_STEP} was not recorded")
    rows = check_recorded(torch, sl.calls)
    for r in rows:
        need(r["ok"], f"regression {name}: {r['name']} at {r['shape']} "
                      f"disagrees with its plain version: {r['errs']}")
    need(set(expect) <= {r["name"] for r in rows},
         f"regression {name}: step {REGRESSION_RECORD_STEP} recorded "
         f"{sorted({r['name'] for r in rows})}, not all of {expect}")
    steady = sl.per_step[1:] or sl.per_step
    per_steady = {k: sum(s[k] for s in steady) / len(steady)
                  for k in launches if launches[k]}
    nums = {k: v for k, v in res.items() if k != "levels"}
    levels = [list(b[1]) for b in res.get("levels", [])]
    verdict = (f"failed as the reference harness does: {failed}" if failed
               else "checks passed")
    print(f"  {name}: {verdict}; {nums}; levels {levels}; wall "
          f"{wall:.3f} s; launches a steady "
          f"step { {k: round(c, 2) for k, c in per_steady.items()} }; "
          f"{len(rows)} recorded kernel calls within "
          f"{max(r['worst'] for r in rows):.3e} of TOL_KERNEL", flush=True)
    return {"result": res, "failed": failed, "wall_s": wall,
            "levels": levels, "launches": launches,
            "launches_per_steady_step": per_steady,
            "kernel_checks": rows}


def regression_check_cfg(name):
    """A workload's quick config cut to REGRESSION_CHECK_STEPS steps,
    without plotfiles or checkpoints, quiet."""
    from varden_tpu_torch import regression
    return regression._load(name, False, max_step=REGRESSION_CHECK_STEPS,
                            plot_int=-1, chk_int=-1, verbose=0)


# phase 19's processes beside the main one: the CPU half of the card
# against CPU comparison (REGRESSION_CPU_THREADS torch threads), and the
# longest quick workload (bubble-2d: 100 steps of a host-bound 4-level 2-D
# step), each with a deadline
REGRESSION_CPU_THREADS = 4
REGRESSION_APART = ("bubble-2d",)
REGRESSION_PROC_TIMEOUT = 900.0


def regression_cpu_runs(path):
    """The CPU plain path's run_states of every workload's
    regression_check_cfg, saved to ``path`` (torch.save): the CPU half of
    phase 19's comparison, run in a process of its own."""
    import torch
    from varden_tpu_torch import regression
    torch.set_num_threads(REGRESSION_CPU_THREADS)
    out = {}
    for name in regression.WORKLOADS:
        boxes, states, sec = run_states(regression_check_cfg(name), "cpu")
        out[name] = (boxes, [{k: getattr(st, k) for k in ("u", "s", "gp",
                                                          "p")}
                             for st in states], sec)
    torch.save(out, path)


def regression_workload_proc(name, path):
    """phase_regression_workload of ``name`` on the card in a process of
    its own, its result pickled to ``path``."""
    import pickle

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    out = phase_regression_workload(torch, name)
    with open(path, "wb") as f:
        pickle.dump(out, f)


class RegressionApart:
    """REGRESSION_APART's quick workloads, each on the card in a process of
    its own (regression_workload_proc), started when made: main() starts
    them beside phase 17, phase 19 reads their results; stop() ends any
    still running and removes their files."""

    def __init__(self):
        import multiprocessing
        import tempfile
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_p19_")
        ctx = multiprocessing.get_context("spawn")
        self.paths = {name: os.path.join(self.tmp, name)
                      for name in REGRESSION_APART}
        self.procs = {name: ctx.Process(target=regression_workload_proc,
                                        args=(name, self.paths[name]))
                      for name in REGRESSION_APART}
        for proc in self.procs.values():
            proc.start()

    def results(self, deadline):
        """Each workload's phase_regression_workload result, waiting for
        its process until ``deadline`` (time.perf_counter())."""
        import pickle
        out = {}
        for name, proc in self.procs.items():
            proc.join(max(0.0, deadline - time.perf_counter()))
            need(proc.exitcode == 0, f"phase 19: the process of {name} "
                                     f"ended with {proc.exitcode}")
            with open(self.paths[name], "rb") as f:
                out[name] = pickle.load(f)
        return out

    def stop(self):
        import shutil
        for proc in self.procs.values():
            if proc.is_alive():
                proc.terminate()
            proc.join()
        shutil.rmtree(self.tmp, ignore_errors=True)


def phase_regression(torch, apart=None):
    """Phase 19: the eight quick workloads on the card (float64, as
    shipped), REGRESSION_APART's in processes of their own (``apart``, a
    RegressionApart already started, or one started here), while another
    process runs each workload's first REGRESSION_CHECK_STEPS steps on the
    CPU plain path; the same steps on the card, and the 2-D workloads' in
    float32 against float64 (TOL_F32_VS_F64_2D); then the card's steps
    against the CPU's (float64, TOL_STEP)."""
    import multiprocessing
    import types
    from varden_tpu_torch import regression
    out = {"quick": {}, "card_vs_cpu": {}, "f32_vs_f64": {}}
    own = apart is None
    apart = RegressionApart() if own else apart
    path = os.path.join(apart.tmp, "cpu")
    proc = multiprocessing.get_context("spawn").Process(
        target=regression_cpu_runs, args=(path,))
    proc.start()
    try:
        quick = {name: phase_regression_workload(torch, name)
                 for name in regression.WORKLOADS
                 if name not in REGRESSION_APART}
        torch.cuda.empty_cache()
        # the card's halves while the other processes run
        card = {name: run_states(regression_check_cfg(name), None)
                for name in regression.WORKLOADS}
        for name in regression.WORKLOADS:
            if regression._load(name, False).dm == 2:
                print(f"  {name} float32 against float64, "
                      f"{REGRESSION_CHECK_STEPS} steps", flush=True)
                recs = {dt: step_extrema(torch, regression._load(
                            name, False, max_step=REGRESSION_CHECK_STEPS,
                            dtype=dt, verbose=0))
                        for dt in ("float64", "float32")}
                hold_f32_to_f64(recs["float32"], recs["float64"],
                                TOL_F32_VS_F64_2D)
                out["f32_vs_f64"][name] = recs
        t0 = time.perf_counter()
        deadline = t0 + REGRESSION_PROC_TIMEOUT
        proc.join(REGRESSION_PROC_TIMEOUT)
        need(proc.exitcode == 0, "phase 19: the process of the CPU runs "
                                 f"ended with {proc.exitcode}")
        cpu = torch.load(path)
        quick.update(apart.results(deadline))
        print(f"  phase 19's other processes ended "
              f"{time.perf_counter() - t0:.1f} s after the main one's work",
              flush=True)
    finally:
        if proc.is_alive():
            proc.terminate()
        proc.join()
        if own:
            apart.stop()
    out["quick"] = {name: quick[name] for name in regression.WORKLOADS}
    print(f"  card vs CPU, float64, the first {REGRESSION_CHECK_STEPS} steps "
          "of each quick config", flush=True)
    for name in regression.WORKLOADS:
        boxes, fields, sec = cpu[name]
        print(f"  {name}:", flush=True)
        out["card_vs_cpu"][name] = hold_card_to_cpu(
            torch, card[name],
            (boxes, [types.SimpleNamespace(**f) for f in fields], sec),
            REGRESSION_CHECK_STEPS)
    return out

def field_errs_ml(got, ref):
    """{field: max over patches of max|got - ref| / max(1, max|ref|)}."""
    out = {}
    for a, b in zip(got, ref):
        for k in ("u", "s", "gp", "p"):
            x, y = a[k].double(), b[k].double()
            out[k] = max(out.get(k, 0.0), float((x - y).abs().max())
                         / max(1.0, float(y.abs().max())))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="profile one more step; write the table here")
    args = ap.parse_args(argv)

    t_begin = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from varden_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: varden_tpu_torch is not beside this script ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    count_cycles()

    smi = smi_name_power()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    build_s = _cuda.build_all()
    for name in _cuda.SOURCES:
        _cuda.lib(name)
    print(f"phase 1: built {len(_cuda.SOURCES)} kernel libraries in "
          f"{build_s:.2f} s ({time.perf_counter() - t0:.2f} s with loading)",
          flush=True)

    print(f"phase 2: kernels vs plain versions at 256^3, {N_2D}^2, the "
          f"AMR patches {N_AMR_PATCHES} and config 4's {N_RT_PADDED}",
          flush=True)
    rows32, rows64 = [], []
    for cases_fn in (kernel_cases, kernel_cases_2d, kernel_cases_amr,
                     kernel_cases_rt, kernel_cases_smoothers,
                     kernel_cases_velpred, kernel_cases_gsrb2d_fused):
        rows32 += phase_kernels(torch, "float32", REPS, cases_fn)
        rows64 += phase_kernels(torch, "float64", max(2, REPS // 4), cases_fn)
        torch.cuda.empty_cache()
    pad_ms = {"float32": pad_ghost_report(torch, "float32", REPS),
              "float64": pad_ghost_report(torch, "float64", REPS // 4)}

    print("phase 3: one float64 step, card vs CPU plain path: inviscid, "
          "then visc_coef = diff_coef = 1e-3", flush=True)
    phase_step(torch, bubble_kw(32, "float64"))
    phase_step(torch, bubble_kw(32, "float64", visc_coef=1.0e-3,
                                diff_coef=1.0e-3))
    torch.cuda.empty_cache()

    print(f"phase 4: main path, viscous 3-D bubble 256^3 float32 "
          f"(visc_coef 1e-3), {STEPS} steps", flush=True)
    v, state, launches, per_step, peak = phase_main(
        torch, bubble_kw(256, "float32", visc_coef=1.0e-3), STEPS, KERNELS_3D)
    visc = viscous_report(per_step)
    prof3 = (profile_step(torch, v, state, args.profile) if args.profile
             else None)
    del v, state
    torch.cuda.empty_cache()

    print(f"phase 5: the main path in float64, {STEPS_SHORT} steps, and "
          "the float32 run against it", flush=True)
    _, _, _, per_step64, _ = phase_main(
        torch, bubble_kw(256, "float64", visc_coef=1.0e-3), STEPS_SHORT,
        KERNELS_3D)
    hold_f32_to_f64(per_step, per_step64)
    torch.cuda.empty_cache()

    print(f"phase 6: the inviscid 3-D bubble 256^3 float32, "
          f"{STEPS_SHORT} steps", flush=True)
    _, _, launches0, per_step0, peak0 = phase_main(
        torch, bubble_kw(256, "float32"), STEPS_SHORT, INVISCID)
    torch.cuda.empty_cache()

    print("phase 7: one float64 2-D step at 64^2, card vs CPU plain path: "
          "inviscid, then visc_coef = diff_coef = 1e-3", flush=True)
    phase_step(torch, bubble2d_kw(64, "float64", visc_coef=0.0))
    phase_step(torch, bubble2d_kw(64, "float64", diff_coef=1.0e-3))

    print(f"phase 8: the 2-D main path, the viscous 2-D bubble's geometry at "
          f"{N_2D}^2 float32 with nu dt / dx^2 held at 0.59 (visc_coef "
          f"{VISC_2D:.4e}, cflfac 0.9), {STEPS} steps", flush=True)
    v, state, launches2, per_step2, peak2 = phase_main(
        torch, bubble2d_kw(N_2D, "float32", visc_coef=VISC_2D), STEPS,
        KERNELS_2D)
    visc2 = viscous_report(per_step2)
    prof2 = None
    if args.profile:
        root, ext = os.path.splitext(args.profile)
        prof2 = profile_step(torch, v, state, root + "_2d" + ext)
    del v, state
    torch.cuda.empty_cache()
    print(f"  the same path in float64, {STEPS_SHORT} steps, and the "
          "float32 run against it", flush=True)
    _, _, _, per_step2_64, peak2_64 = phase_main(
        torch, bubble2d_kw(N_2D, "float64", visc_coef=VISC_2D), STEPS_SHORT,
        KERNELS_2D)
    hold_f32_to_f64(per_step2, per_step2_64, TOL_F32_VS_F64_2D)
    torch.cuda.empty_cache()

    print(f"phase 9: the published 2-D configurations, float32, {STEPS} "
          f"steps each: inviscid 64^2, viscous (visc_coef 1e-3) 128^2 and "
          f"{N_2D_PUBLISHED}^2", flush=True)
    small = {}
    for key, kw in (("inviscid-64", bubble2d_kw(64, "float32", visc_coef=0.0)),
                    ("viscous-128", bubble2d_kw(128, "float32")),
                    (f"viscous-{N_2D_PUBLISHED}",
                     bubble2d_kw(N_2D_PUBLISHED, "float32"))):
        _, _, ln, steps_small, _ = phase_main(torch, kw, STEPS, KERNELS_2D)
        small[key] = {"launches": ln, "steps": steps_small,
                      "mean_step_s": mean_steady(steps_small)}
        if kw["visc_coef"] > 0.0:
            small[key]["viscous_solve"] = viscous_report(steps_small)
        torch.cuda.empty_cache()

    print(f"phase 10: AMR on the card vs the CPU plain path, float64: "
          f"BASELINE config 5 at a 32^3 base, {STEPS_SHORT} steps",
          flush=True)
    amr_check = phase_run(torch, cfg5_kw(32, "float64"), STEPS_SHORT)
    torch.cuda.empty_cache()
    print(f"  config 5 at a {N_AMR_HOLD}^3 base on the card, float64 then "
          f"float32, {STEPS_SHORT} steps each, and the float32 run against "
          "the float64 one", flush=True)
    from varden_tpu_torch.config import VardenConfig, load_config
    amr_hold = {}
    for dtype_name in ("float64", "float32"):
        _, _, _, ps, pk, _ = phase_main_ml(
            torch, VardenConfig(**cfg5_kw(N_AMR_HOLD, dtype_name)),
            STEPS_SHORT, KERNELS_AMR, f"config 5 {N_AMR_HOLD}^3 {dtype_name}")
        amr_hold[dtype_name] = {"steps": ps, "peak_bytes": pk}
        torch.cuda.empty_cache()
    hold_f32_to_f64(amr_hold["float32"]["steps"], amr_hold["float64"]["steps"])

    print(f"phase 11: the AMR main path, BASELINE config 5 at 256^3 + 2 "
          f"levels, float32, initialization and {STEPS_AMR} steps",
          flush=True)
    v, states, launches_amr, per_step_amr, peak_amr, init_amr = \
        phase_main_ml(torch, VardenConfig(**cfg5_kw(256, "float32")),
                      STEPS_AMR, KERNELS_AMR, "config 5")
    prof_amr = None
    if args.profile:
        root, ext = os.path.splitext(args.profile)
        prof_amr = profile_step(torch, v, states, root + "_amr" + ext)
    del v, states
    torch.cuda.empty_cache()

    print("phase 12: regrids in the loop: inputs/inputs_3d-regt (64^3, 3 "
          "levels, regrid every 2) for 4 steps, then BASELINE config 3 (2-D "
          "64^2, 2 levels, regrid every 4) for 6 steps, float32", flush=True)
    regrid_runs = {}
    for key, cfg, steps, expect in (
            ("3d-regt", load_config(os.path.join(HERE, "inputs",
                                                 "inputs_3d-regt"),
                                    dtype="float32", plot_int=-1,
                                    max_step=4), 4, KERNELS_AMR),
            ("config 3", VardenConfig(**cfg3_kw("float32")), 6, KERNELS_2D)):
        _, _, ln, ps, pk, _ = phase_main_ml(torch, cfg, steps, expect, key)
        need(any(r["regrid"] for r in ps), f"{key}: no regrid happened")
        regrid_runs[key] = {"launches": ln, "steps": ps, "peak_bytes": pk}
        torch.cuda.empty_cache()

    print(f"phase 13: config 4's geometry at {N_RT_CHECK}^3, card vs CPU "
          f"plain path, float64, {STEPS_SHORT} steps", flush=True)
    rt_check = phase_run(torch, rt_kw(N_RT_CHECK, "float64"), STEPS_SHORT)
    torch.cuda.empty_cache()

    print(f"phase 14: the config 4 main path, 3-D Rayleigh-Taylor {N_RT}^3 "
          f"float32 (visc_coef 1e-3, cflfac 0.9), {STEPS} steps", flush=True)
    v, state, launches_rt, per_step_rt, peak_rt = phase_main(
        torch, rt_kw(N_RT, "float32"), STEPS, KERNELS_RT, bubble=False,
        fused=FUSED_RT)
    prof_rt = None
    if args.profile:
        root, ext = os.path.splitext(args.profile)
        prof_rt = profile_step(torch, v, state, root + "_rt" + ext)
    del v, state
    torch.cuda.empty_cache()
    print(f"  the same path in float64, {STEPS_SHORT} steps, and the "
          "float32 run against it (density extrema and max|u|)", flush=True)
    _, _, _, per_step_rt64, _ = phase_main(
        torch, rt_kw(N_RT, "float64"), STEPS_SHORT, KERNELS_RT, bubble=False,
        fused=FUSED_RT)
    hold_f32_to_f64(per_step_rt, per_step_rt64)
    torch.cuda.empty_cache()

    print(f"phase 15: I/O on the card: inputs/inputs_RayleighTaylor_3d to "
          f"step {RT_IO_STEPS} (a checkpoint every {RT_IO_CHK}) and its "
          f"restart, then config 4 {N_RT}^3 float32 restarted from step 2",
          flush=True)
    io = phase_io(torch)
    torch.cuda.empty_cache()
    print(f"  {time.perf_counter() - t_begin:.1f} s since the start",
          flush=True)

    print("phase 16: the decomposed single-level path, gloo ranks sharing "
          f"the card: the viscous 3-D bubble and config 4's geometry at "
          f"{N_DECOMP_CHECK}^3 float64 on 2 and 4 ranks, the headline and "
          f"config 2's geometry at {N_2D_PUBLISHED}^2 on 4 in float64 and "
          "float32, each against its one-rank run, and every kernel call of "
          "a rank against its plain version", flush=True)
    t_phase = time.perf_counter()
    decomposed = phase_decomposed(torch, list(decomp_cells()))
    print(f"  phase 16 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    print("phase 17: AMR under a mesh, every patch of every level cut over "
          "gloo ranks sharing the card: config 5 at a "
          f"{N_AMR_DECOMP}^3 base float64 on 2 and 4 ranks and at 256^3 "
          "float32 on 4, config 3 across a regrid and the RT inputs to "
          f"step {RT_IO_DECOMP_STEPS} with plotfiles, checkpoints and a "
          f"restart from step {RT_IO_DECOMP_CHK} on 4, each against its "
          "one-rank run at the same mesh, and every kernel call of a rank "
          "against its plain version", flush=True)
    t_phase = time.perf_counter()
    # phase 19's longest quick workload runs beside phases 17 and 18
    apart = RegressionApart()
    try:
        decomposed_amr = phase_decomposed_amr(torch,
                                              list(amr_decomp_cells()))
        print(f"  phase 17 took {time.perf_counter() - t_phase:.1f} s "
              f"({', '.join(REGRESSION_APART)} of phase 19 beside it); "
              f"{time.perf_counter() - t_begin:.1f} s since the start",
              flush=True)

        print(f"phase 18: the tail: profiling.profile_phases on the headline "
              f"256^3 (kernels 11 and 6 recorded and held to their plain "
              f"versions) and on config 2's geometry at {N_2D}^2, "
              f"profile_phases_ml on config 5 at 256^3 + 2 levels, "
              f"{TAIL_REPS} timed calls a phase; then use_godunov_debug on "
              "the card in float64 against the runs without it", flush=True)
        t_tail = time.perf_counter()
        tail = phase_tail(torch)
        print(f"  phase 18 took {time.perf_counter() - t_tail:.1f} s",
              flush=True)

        print("phase 19: the regression suite on the card: the eight "
              "quick workloads of varden_tpu_torch.regression in float64 "
              "with their checks, launches and recorded kernel calls, each "
              f"one's first {REGRESSION_CHECK_STEPS} steps card vs CPU, the "
              "2-D ones in float32 against float64", flush=True)
        t_reg = time.perf_counter()
        regression_runs = phase_regression(torch, apart)
        print(f"  phase 19 took {time.perf_counter() - t_reg:.1f} s",
              flush=True)
    finally:
        apart.stop()

    # the JSON line: for each kernel its main case (velocity update, the
    # fused pre-smooth stage of the two V-cycles; the AMR kernels at the
    # finest patch; kernel
    # 7's at config 4's finest MAC level); max_abs_err the largest
    # over its cases
    main_case = {"velpred_3d_fused": "velocity",
                 "mkflux_update_3d_fused": "velocity",
                 "gsrb_var_sweep_3d": "smooth_restrict 256^3",
                 "nodal_sweep_3d": "smooth_restrict 256^3",
                 "gsrb_const_sweep_3d": "sweep B3",
                 "gsrb_sweep_2d": f"smooth_restrict {N_2D}^2",
                 "velpred_2d_fused": "walls", "mkflux_2d_fused": "velocity",
                 "update_3d": "nc2 [T,F] 384x384x384",
                 "mkflux_3d_fused": "scalars 384x384x384",
                 "gsrb_sweep_3d": f"smooth_restrict {N_RT}^3"}
    launches_3d = dict(launches)
    launches.update({k: launches2[k] for k in KERNELS_2D})
    # kernels 11 and 6: their launches on the path that runs them, phase
    # 18's profile_phases on the headline
    launches.update({k: tail["headline"]["launches"][k] for k in OFF_PATH})
    launches["gsrb_sweep_3d"] = launches_rt["gsrb_sweep_3d"]
    kernels = []
    for name in REPLACES:
        r = next(x for x in rows32 if x["name"] == name
                 and x["case"] == main_case[name])
        err = max(x["max_abs_err"] for x in rows32 if x["name"] == name)
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCE[name], "replaces": REPLACES[name],
                        "launches": launches[name], "max_abs_err": err,
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": None})
    total_s = time.perf_counter() - t_begin
    detail = {"card": smi, "build_s": build_s, "peak_bytes": peak,
              "cases_f32": rows32, "cases_f64": rows64, "steps": per_step,
              "mean_step_s": mean_steady(per_step),
              "viscous_solve": visc, "steps_f64": per_step64,
              "inviscid_steps": per_step0,
              "inviscid_launches": launches0, "inviscid_peak_bytes": peak0,
              "steps_2d": per_step2, "launches_2d": launches2,
              "peak_bytes_2d": peak2, "peak_bytes_2d_f64": peak2_64,
              "mean_step_s_2d": mean_steady(per_step2),
              "viscous_solve_2d": visc2, "steps_2d_f64": per_step2_64,
              "profiled_step": prof3, "profiled_step_2d": prof2,
              "small_2d": small, "amr_card_vs_cpu": amr_check,
              "amr_f32_vs_f64": amr_hold,
              "steps_amr": per_step_amr, "launches_amr": launches_amr,
              "peak_bytes_amr": peak_amr, "init_s_amr": init_amr,
              "profiled_step_amr": prof_amr, "regrid_runs": regrid_runs,
              "pad_ghost_ms": pad_ms, "rt_card_vs_cpu": rt_check,
              "steps_rt": per_step_rt, "launches_rt": launches_rt,
              "peak_bytes_rt": peak_rt, "steps_rt_f64": per_step_rt64,
              "profiled_step_rt": prof_rt, "io": io,
              "decomposed": decomposed, "decomposed_amr": decomposed_amr,
              "tail": tail, "regression": regression_runs,
              "total_s": total_s}
    print("detail " + json.dumps(detail), flush=True)
    # the main paths once more in short, where the end of the output keeps them
    runs = [("3-D main path (phase 4)", per_step, launches_3d, prof3),
            ("2-D main path (phase 8)", per_step2, launches2, prof2)]
    runs += [(f"published 2-D {key} (phase 9)", r["steps"], r["launches"],
              None) for key, r in small.items()]
    runs.append(("AMR main path, config 5 256^3 + 2 levels (phase 11)",
                 per_step_amr, launches_amr, prof_amr))
    runs += [(f"AMR {key} (phase 12)", r["steps"], r["launches"], None)
             for key, r in regrid_runs.items()]
    runs.append((f"config 4 main path, RT {N_RT}^3 (phase 14)", per_step_rt,
                 launches_rt, prof_rt))
    for tag, ps, ln, pr in runs:
        mean = mean_steady(ps)
        cells = ps[-1]["cells"]
        cells = cells if isinstance(cells, int) else math.prod(cells)
        line = (f"summary {tag}: steady step {mean:.4f} s, "
                f"{cells / mean:.4e} cells/s; density "
                f"min/max {min(r['rho_min'] for r in ps):.8f} / "
                f"{max(r['rho_max'] for r in ps):.8f}; launches "
                f"{ {k: c for k, c in ln.items() if c} }")
        if "levels" in ps[-1]:
            line += f"; levels {ps[-1]['levels']}"
        if pr:
            line += (f"; profiled step {pr['wall_s']:.4f} s, device busy "
                     f"{pr['device_s']:.4f} s, own kernels "
                     f"{pr['own_kernels_device_s']:.4f} s")
        print(line, flush=True)
    print(f"summary AMR main path (phase 11): initialization {init_amr:.3f} s;"
          f" peak device memory {peak_amr} bytes", flush=True)
    steady = per_step_amr[1:] or per_step_amr
    print("summary AMR main path (phase 11): launches per steady step "
          + ", ".join(f"{k} {[r['launches'][k] for r in steady]}"
                      for k in ("mkflux_update_3d_fused",) + OFF_PATH),
          flush=True)
    for tag, ps in (("3-D main path (phase 4)", per_step),
                    ("AMR main path (phase 11)", per_step_amr),
                    ("config 4 main path (phase 14)", per_step_rt)):
        steady = ps[1:] or ps
        print(f"summary {tag}: kernels 3, 4, 5 and 7, launches per steady "
              "step (of them the fused stages) "
              + ", ".join(f"{k} {[r['launches'][k] for r in steady]} "
                          f"({[r['launches'][k + ':fused'] for r in steady]})"
                          for k in FUSED_3D + ("gsrb_sweep_3d",))
              + "; kernel 1 velpred_3d_fused "
              f"{[r['launches']['velpred_3d_fused'] for r in steady]}",
              flush=True)
    runs_2d = [("2-D main path (phase 8)", per_step2)]
    runs_2d += [(f"published 2-D {key} (phase 9)", r["steps"])
                for key, r in small.items()]
    runs_2d.append(("AMR config 3 (phase 12)",
                    regrid_runs["config 3"]["steps"]))
    for tag, ps in runs_2d:
        steady = ps[1:] or ps
        print(f"summary {tag}: kernels 8, 9 and 10, launches per steady step"
              " gsrb_sweep_2d "
              f"{[r['launches']['gsrb_sweep_2d'] for r in steady]} (fused "
              f"{[r['launches']['gsrb_sweep_2d:fused'] for r in steady]}), "
              + ", ".join(f"{k} {[r['launches'][k] for r in steady]}"
                          for k in ("velpred_2d_fused", "mkflux_2d_fused")),
              flush=True)
    print(f"summary config 4 main path (phase 14): peak device memory "
          f"{peak_rt} bytes; density min/max by step "
          f"{[(r['rho_min'], r['rho_max']) for r in per_step_rt]}",
          flush=True)
    print(f"summary I/O (phase 15): RT inputs run {io['run_s']:.3f} s, "
          f"restart {io['restart_s']:.3f} s; seconds per call "
          + ", ".join(f"{k} {r['mean_s']:.4f}" for k, r in io["io_s"].items()),
          flush=True)
    for r in decomposed:
        steps_r = r["records"][0]["per_step"]
        steady = steps_r[1:] or steps_r
        one_steady = r["one_rank_steps"][1:] or r["one_rank_steps"]
        print(f"summary decomposed {r['label']} on {r['ranks']} gloo ranks "
              f"of one card (phase 16; the cost of the decomposition on one "
              f"card, not a scaling): fields within {r['max_rel_err']:.3e} "
              f"of the one-rank run; {len(r['kernel_checks'])} kernel calls "
              f"at the ranks' inputs within "
              f"{max(c['worst'] for c in r['kernel_checks']):.3e} of their "
              f"tolerance; steady step {mean_steady(steady):.4f} s against "
              f"{mean_steady(one_steady):.4f} s on one rank; per rank and "
              "steady step halo exchanges "
              + ", ".join(
                  f"r{rec['rank']} "
                  f"{[s['exchanges']['count'] for s in steady_of(rec)]}"
                  for rec in r["records"]), flush=True)
    for r in decomposed_amr:
        rec0 = r["records"][0]
        steady = steady_of(rec0)
        one_steady = r["one_rank_steps"][1:] or r["one_rank_steps"]
        print(f"summary decomposed AMR {r['label']} on {r['ranks']} gloo "
              f"ranks of one card (phase 17; the cost of the decomposition "
              f"on one card, not a scaling): fields within "
              f"{r['max_rel_err']:.3e} of the one-rank run; "
              f"{len(r['kernel_checks'])} kernel calls at the ranks' inputs "
              f"within {max(c['worst'] for c in r['kernel_checks']):.3e} of "
              f"their tolerance; steady step {mean_steady(steady):.4f} s "
              f"against {mean_steady(one_steady):.4f} s on one rank; rank 0 "
              f"a steady step: exchanges "
              f"{[s['exchanges']['count'] for s in steady]}, fetch/put "
              f"calls {[s['copies']['count'] for s in steady]}, elements "
              f"{[s['copies']['elements'] for s in steady]}, seconds "
              f"{[round(s['copies']['seconds'], 4) for s in steady]}; "
              "launches a steady step "
              + ", ".join(f"{k} {[s['launches'][k] for s in steady]}"
                          for k in sorted(rec0["launches"])
                          if ":" not in k and rec0["launches"][k]),
              flush=True)
    for key, r in tail.items():
        if key == "debug":
            continue
        print(f"summary profile phases {key} (phase 18): "
              + ", ".join(f"{k} {t:.6f} s" for k, t in r["phases"].items())
              + f"; launches { {k: c for k, c in r['launches'].items() if c} }"
              + (f"; {len(r['kernel_checks'])} recorded kernel calls within "
                 f"{max(c['worst'] for c in r['kernel_checks']):.3e} of "
                 "their tolerance" if r["kernel_checks"] else ""),
              flush=True)
    for key, r in tail["debug"].items():
        print(f"summary use_godunov_debug {key} (phase 18): within "
              f"{r['max_rel_err']:.3e} of the run without the flag; "
              f"launches { {k: c for k, c in r['launches'].items() if c} }",
              flush=True)
    for name, r in regression_runs["quick"].items():
        res = {k: v for k, v in r["result"].items() if k != "levels"}
        err = max(regression_runs["card_vs_cpu"][name]["max_abs_err"]
                  .values())
        per = {k: round(c, 2)
               for k, c in r["launches_per_steady_step"].items()}
        print(f"summary regression {name} (phase 19): "
              + (f"failed as the reference harness does: {r['failed']}"
                 if r["failed"] else "checks passed")
              + f"; {res}; levels {r['levels']}; wall {r['wall_s']:.3f} s; "
              f"card vs CPU within {err:.3e}; launches a steady step {per}",
              flush=True)
    print(f"total wall time {total_s:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(3)
