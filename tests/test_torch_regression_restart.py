"""The restart regression workload (inputs/inputs-restart-regt: the 3-D
bubble in a box with walls, regrid every 2 steps, a checkpoint every 4) at
an 8^3 base with its three levels, float64, CPU: the port's run of 8 steps
restarted from chk00004 equals its continuous run bitwise on every patch
(varden_tpu_torch.regression.bubble_restart), and the step the restart
resumes with follows varden_tpu's.

At this base (as at 16^3) level 1 covers the domain with walls on every
side, so its composite nodal correction problem is singular: the
three-level departure of ROADMAP.md section 3, held with
tests/test_torch_amr_3level.py's method.
varden_tpu's ml_advance (under jax.jit) takes the port's step from the
port's checkpointed state and warm starts (chk00004, hierarchy 8^3, 16^3
and 32^3 over the domain), with the port's regularisation patched in (a
fine level whose nodal mask fixes no node gets its multigrid hierarchy
built with mask None), and agrees in every field of every patch within
1e-9 of its size. varden_tpu's whole run of 8 steps is not taken: one
compile of its three-level step takes 2-4 minutes on one core, and at a
16^3 base a step 40-90 s (tests/test_torch_amr_3level.py holds step 1 of
the 16^3 run the same way)."""
import os

import jax
import jax.numpy as jnp
import numpy as np

from torch_inputs import one_torch_thread  # noqa: F401
from torch_inputs import regularise_reference, state_arrays
from varden_tpu.amr import advance_ml as jadv
from varden_tpu.amr import fill as jfill
from varden_tpu.amr import hierarchy as jh
from varden_tpu.config import load_config as jload
from varden_tpu.state import Sim as JSim
from varden_tpu.state import State as JState
from varden_tpu_torch import regression as reg
from varden_tpu_torch.amr import advance_ml as tadv
from varden_tpu_torch.driver import Varden as TVarden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATH = os.path.join(ROOT, "inputs", "inputs-restart-regt")
OVER = dict(n_cellx=8, n_celly=8, n_cellz=8, max_levs=3)


def _spy_resumed_step(monkeypatch):
    """Record the inputs and output of the first ml_advance after a
    restart_ml (the step the restarted run resumes with)."""
    seen, resumed = [], []
    restart_ml, advance = TVarden.restart_ml, tadv.ml_advance

    def spied_restart(self):
        resumed.append(True)
        return restart_ml(self)

    def spied_advance(geom, states, dt, proj_type, hints=None):
        if not resumed or seen:
            return advance(geom, states, dt, proj_type, hints=hints)
        entry = dict(geom=geom, states=state_arrays(states), dt=float(dt),
                     proj_type=proj_type,
                     hints={k: [t.numpy().copy() for t in v]
                            for k, v in (hints or {}).items()})
        out = advance(geom, states, dt, proj_type, hints=hints)
        entry["out"] = state_arrays(out[0])
        seen.append(entry)
        return out

    monkeypatch.setattr(TVarden, "restart_ml", spied_restart)
    monkeypatch.setattr(tadv, "ml_advance", spied_advance)
    return seen


def test_restart_at_three_levels_is_bitwise_and_resumes_as_varden_tpu(
        monkeypatch):
    seen = _spy_resumed_step(monkeypatch)
    out = reg.bubble_restart(device="cpu", verbose=0, **OVER)
    assert out["bitwise"] and out["steps"] == 8 and out["steps_run"] == 12
    assert len(out["levels"]) == 3 and len(seen) == 1
    step = seen[0]
    geom = step["geom"]
    assert [tuple(s.n) for s in geom.specs] == \
        [(8, 8, 8), (16, 16, 16), (32, 32, 32)]
    assert set(step["hints"]) >= {"phi_mac", "phi_hg"}

    free = regularise_reference(monkeypatch)
    jg = jfill.MLGeom(JSim(jload(PATH, dtype="float64", **OVER)),
                      [jh.LevelSpec(tuple(s.lo), tuple(s.n))
                       for s in geom.specs], list(geom.parent),
                      list(geom.depth))
    jst = [JState(**{k: jnp.asarray(v) for k, v in a.items()})
           for a in step["states"]]
    hints = {k: [jnp.asarray(v) for v in vs]
             for k, vs in step["hints"].items()}
    jout, jdiag = jax.jit(lambda st, h: jadv.ml_advance(
        jg, st, step["dt"], step["proj_type"], hints=h))(jst, hints)
    assert free, "no fine level of varden_tpu's step was regularised"
    assert float(jdiag["hg_ratio"]) <= 1.0
    for a, b in zip(step["out"], state_arrays(jout)):
        for k in a:
            scale = max(1.0, float(np.abs(b[k]).max()))
            assert float(np.abs(a[k] - b[k]).max()) <= 1e-9 * scale, k
