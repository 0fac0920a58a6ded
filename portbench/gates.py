"""The gates a step must pass, as chip_smoke.py (phase_main, phase_main_ml)
holds them: every solve at or below its tolerance (ratio <= 1, the dtype's
roundoff floor included), div(umac) falling across the MAC projection,
the bubble's density inside its range. They read only what the step
itself reports (``Varden.last_diag``), so they add no work on the device;
the fields' finiteness is checked once, after the window."""
from __future__ import annotations

from typing import Dict, List


def step_failures(diag: Dict, gates: Dict) -> List[str]:
    """The gates this step's diagnostics break (empty: it passed)."""
    out = []
    for k in ("mac_ratio", "hg_ratio", "visc_ratio"):
        if k in diag and not float(diag[k]) <= 1.0:
            out.append(f"{k} {float(diag[k])}")
    if not float(diag["div_after"]) < float(diag["div_before"]):
        out.append(f"div_after {float(diag['div_after'])} >= div_before "
                   f"{float(diag['div_before'])}")
    rng = gates.get("density_range")
    if rng is not None:
        tol = gates["density_tol"]
        lo, hi = float(diag["smin"]), float(diag["smax"])
        if not (rng[0] - tol <= lo and hi <= rng[1] + tol):
            out.append(f"density [{lo}, {hi}] outside {rng} +- {tol}")
    return out


def field_failures(states, gates: Dict) -> List[str]:
    """After the window: every field of every level finite, and the
    density of every level inside the range."""
    out = []
    rng = gates.get("density_range")
    for lev, st in enumerate(states):
        for key in ("u", "s", "gp", "p"):
            if not bool(getattr(st, key).isfinite().all()):
                out.append(f"level {lev} {key} not finite")
        if rng is not None:
            tol = gates["density_tol"]
            lo, hi = float(st.s[0].min()), float(st.s[0].max())
            if not (rng[0] - tol <= lo and hi <= rng[1] + tol):
                out.append(f"level {lev} density [{lo}, {hi}] outside {rng}")
    return out
