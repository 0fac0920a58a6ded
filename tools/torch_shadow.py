#!/usr/bin/env python3
"""Shadow a run of the port with varden_tpu's, step by step (float64, CPU).

    JAX_PLATFORMS=cpu python3 tools/torch_shadow.py INPUTS [--key value ...]
        [--steps N] [--shadow 85-95,100] [--no_whole]
        [--scalar_wall_bc foextrap] [--save FILE]

INPUTS is an inputs file; ``--key value`` pairs override its settings as
on the port's command line (e.g. ``--max_levs 1 --n_cellx 64``); plotfiles
and checkpoints are off and the dtype is float64 whatever the file says.

Single level (``max_levs`` 1): the port runs to step N (default the file's
max_step). At every step named by ``--shadow`` the port's pre-step state,
dt and warm starts go to varden_tpu's jitted step (``Varden._step``,
varden_tpu/driver.py:39-60) and the two results are compared field by
field. Unless ``--no_whole``, varden_tpu also runs on its own from the same
initial state, on the same compile, and the two runs are compared each
step. varden_tpu takes the port's route to the padded red-black sweep on
periodic-x levels (tests/torch_inputs.py shadow_single).
``--scalar_wall_bc foextrap`` runs the port alone (no varden_tpu, no
shadows) with its scalars' ghost cells at a no-slip wall copied from the
wall row (FOEXTRAP) instead of both packages' (15 s1 - 10 s2 + 3 s3)/8
(HOEXTRAP): a departure from the reference, to see what it would change.
``--save FILE`` runs the port alone to step N and writes its state, warm
starts, step, time and dt to the .npz FILE (tests/torch_inputs.py
save_port_state; shadow_single(start=FILE) goes on from it).

Multi-level: the port's run is held to varden_tpu's ml_advance (one compile
a hierarchy) at the ``--shadow`` steps, with the port's regularisation of a
fine level that fixes no node patched into varden_tpu (ROADMAP.md section
3), and every regrid to varden_tpu's (tests/torch_inputs.hold_port_run).

One line per step: the step, time and dt; each field's largest |delta|
over the field's size between the runs ("run") and of the shadowed step
("shadow"); the density's range in each wall row (the first and the last
cell row of every non-periodic axis; of each patch on a multi-level run)
and in the interior (cells two or more rows from every wall) for the port
and varden_tpu; the single-level solves' V-cycles (MAC, viscous, nodal in
call order) and largest ratio of each package. On 8 cores a 64^3 step of both packages takes ~13 s, a 32^3 step
~3 s, after a compile of a few minutes.
"""
import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402
import torch_inputs as ti  # noqa: E402
from varden_tpu.config import load_config as jload  # noqa: E402
from varden_tpu_torch.config import VardenConfig  # noqa: E402
from varden_tpu_torch.config import load_config as tload  # noqa: E402


def parse_steps(spec):
    """'85-95,100' -> [85, ..., 95, 100]."""
    out = []
    for part in filter(None, (spec or "").split(",")):
        lo, _, hi = part.partition("-")
        out += range(int(lo), int(hi or lo) + 1)
    return out


def typed_overrides(pairs):
    defaults = VardenConfig()
    fields = {f.name for f in dataclasses.fields(VardenConfig)}
    out = {}
    for k, v in pairs.items():
        if k not in fields:
            raise SystemExit(f"unknown parameter --{k}")
        cur = getattr(defaults, k)
        out[k] = (v.lower() in ("t", "true", ".true.", "1")
                  if isinstance(cur, bool) else type(cur)(v))
    return out


def fmt_ranges(rr):
    return " ".join(f"{k} [{lo:.5f},{hi:.5f}]" for k, (lo, hi) in rr.items())


def fmt_deltas(d):
    return " ".join(f"{k} {v:.1e}" for k, v in d.items())


def fmt_cycles(seen):
    if not seen:
        return "-"
    return "/".join(str(c) for _n, c, _r in seen) + \
        f" r{max(r for _n, _c, r in seen):.2g}"


def print_record(rec):
    line = [f"step {rec['step']:4d} t {rec['time']:.6f} dt {rec['dt']:.9f}"]
    if "run" in rec:
        line.append(f"run: {fmt_deltas(rec['run'])}")
    if "shadow" in rec:
        line.append(f"shadow: {fmt_deltas(rec['shadow'])}")
    line.append(f"port: {fmt_ranges(rec['port'])}")
    if "ref" in rec:
        line.append(f"ref: {fmt_ranges(rec['ref'])}")
    cyc = rec["cycles"]
    line.append("cycles port " + fmt_cycles(cyc.get("port")) +
                (" ref " + fmt_cycles(cyc["ref"]) if "ref" in cyc else "") +
                (" shadow " + fmt_cycles(cyc["shadow"])
                 if "shadow" in cyc else ""))
    print(" | ".join(line), flush=True)


def scalar_walls_foextrap(mp):
    """Give the port's scalars FOEXTRAP ghost cells at no-slip walls."""
    from varden_tpu_torch import bc
    table = bc.adv_bc_table

    def adv_bc_table(cfg):
        t = table(cfg)
        for comp in range(cfg.dm, cfg.dm + cfg.nscal):
            for d in range(cfg.dm):
                for side in range(2):
                    if cfg.phys_bc[d][side] == bc.NO_SLIP_WALL:
                        t[comp][d][side] = bc.FOEXTRAP
        return t
    mp.setattr(bc, "adv_bc_table", adv_bc_table)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0].startswith("-"):
        print(__doc__)
        return 1
    path, rest = argv[0], argv[1:]
    own = {"steps": None, "shadow": "", "scalar_wall_bc": None,
           "save": None}
    whole, pairs, i = True, {}, 0
    while i < len(rest):
        k = rest[i].lstrip("-")
        if k == "no_whole":
            whole, i = False, i + 1
            continue
        if i + 1 >= len(rest):
            raise SystemExit(f"option --{k} has no value")
        (own if k in own else pairs)[k] = rest[i + 1]
        i += 2
    over = dict(typed_overrides(pairs), dtype="float64", plot_int=-1,
                chk_int=-1, verbose=0, mg_verbose=0)
    tcfg, jcfg = tload(path, **over), jload(path, **over)
    steps = int(own["steps"]) if own["steps"] else tcfg.max_step
    shadow = parse_steps(own["shadow"])
    print(f"# {path} n {tcfg.n_cell} max_levs {tcfg.max_levs} steps {steps} "
          f"periodic {tcfg.pmask}", flush=True)
    with pytest.MonkeyPatch.context() as mp:
        if tcfg.max_levs > 1:
            def report(step, deltas, got, ref, geom):
                patches = []
                for i, (g, r) in enumerate(zip(got, ref)):
                    lev = geom.depth[i]
                    lo = geom.specs[i].lo
                    dom = [c * tcfg.ref_ratio ** lev for c in tcfg.n_cell]
                    port, jref = (ti.row_ranges(a["s"][0], tcfg.pmask, lo, dom)
                                  for a in (g, r))
                    patches.append(f"L{lev} patch {i} port: {fmt_ranges(port)} "
                                   f"ref: {fmt_ranges(jref)}")
                print(f"step {step:4d} shadow: {fmt_deltas(deltas)} | "
                      + " | ".join(patches), flush=True)
            ti.regularise_reference(mp)
            ti.hold_port_run(path, at=shadow or [steps], report=report,
                             **dict(over, max_step=steps))
            return 0
        if own["scalar_wall_bc"] is not None:
            if own["scalar_wall_bc"] != "foextrap":
                raise SystemExit("--scalar_wall_bc takes foextrap")
            scalar_walls_foextrap(mp)
            shadow, whole = [], False
        if own["save"] is not None:
            save_port_run(tcfg, steps, own["save"])
            return 0
        ti.shadow_single((tcfg, jcfg), steps, shadow=shadow, whole=whole,
                         report=print_record)
    return 0


def save_port_run(tcfg, steps, path):
    """Run the port alone to step ``steps`` and save its state to path."""
    import contextlib
    import io
    from varden_tpu_torch.driver import Varden as TVarden
    tv = TVarden(tcfg, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        state = tv.initialize()
        while tv.istep < steps:
            state = tv.step(state)
    ti.save_port_state(path, tv, state)
    print(f"step {tv.istep} t {tv.time:.6f} dt {tv.dt:.9f} saved to {path}: "
          f"port: {fmt_ranges(ti.row_ranges(state.s[0].numpy(), tcfg.pmask))}",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
