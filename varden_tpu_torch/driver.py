"""Main driver, single level (counterpart of varden_tpu.driver): the
reference's varden() program flow (src/varden.f90:1-665) — init, initial
projection, initial pressure iterations, main step loop.

Ported so far: single-level 2-D and 3-D runs without I/O. Multi-level AMR, the
device mesh, restarts and plotfile/checkpoint output raise
NotImplementedError.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from . import advance, problems, projection
from .config import VardenConfig, load_config
from .state import Sim, State


def _check_supported(cfg: VardenConfig) -> None:
    waits = [(cfg.max_levs > 1, "multi-level AMR (max_levs > 1)"),
             (cfg.mesh > 0, "multi-device runs (mesh > 0)"),
             (cfg.restart >= 0, "restart from a checkpoint (restart >= 0)"),
             (cfg.plot_int > 0, "plotfile output (plot_int > 0)"),
             (cfg.chk_int > 0, "checkpoint output (chk_int > 0)")]
    for cond, what in waits:
        if cond:
            raise NotImplementedError(f"{what} is not ported yet")
    advance.check_supported(cfg)


class Varden:
    """A configured single-level simulation on one device.

    ``device`` defaults to the card; with no card present the constructor
    raises unless ``device="cpu"`` is given (the plain PyTorch path)."""

    def __init__(self, cfg: VardenConfig, device=None):
        _check_supported(cfg)
        self.cfg = cfg
        self.sim = Sim(cfg, device=device)
        self.time = 0.0
        self.dt = 1.0e20
        self.istep = 0
        self._hints = None
        self.last_diag = None

    def _zero_hints(self):
        sim = self.sim
        return {"phi_mac": sim.zeros(sim.n_cell),
                "phi_mac_prev": sim.zeros(sim.n_cell),
                "phi_hg": sim.zeros(sim.node_shape()),
                "phi_hg_prev": sim.zeros(sim.node_shape())}

    def _advance(self, state: State, proj_type: int):
        """One advance_timestep with the hint rotation: the new solutions
        become 'phi_*', the old ones 'phi_*_prev'. The hints dict is
        updated in place (the old prev tensors are dropped)."""
        if self._hints is None:
            self._hints = self._zero_hints()
        h = self._hints
        new_state, diag = advance.advance_timestep(self.sim, state, self.dt,
                                                   proj_type, hints=h)
        h["phi_mac_prev"] = h["phi_mac"]
        h["phi_mac"] = diag.pop("phi_mac")
        h["phi_hg_prev"] = h["phi_hg"]
        h["phi_hg"] = diag.pop("phi_hg")
        return new_state, diag

    def _initial_projection(self, state: State) -> State:
        """Constant-density initial projection (varden.f90:126-138)."""
        rhohalf = torch.ones_like(state.s[0])
        u, p, gp, _phi, _rn, _ratio = projection.hgproject(
            self.sim, projection.INITIAL_PROJECTION, state.u, state.u,
            rhohalf, state.p, state.gp, 1.0)
        return State(u=u, s=state.s, gp=torch.zeros_like(gp),
                     p=torch.zeros_like(p))

    def initialize(self, state: Optional[State] = None) -> State:
        cfg = self.cfg
        if state is None:
            state = problems.initdata(self.sim)
        if cfg.do_initial_projection > 0:
            state = self._initial_projection(state)
        # first dt (varden.f90:186-199)
        self.dt = advance.estdt(self.sim, state, -1.0) * cfg.init_shrink
        if cfg.fixed_dt > 0.0:
            self.dt = cfg.fixed_dt
        if cfg.stop_time >= 0.0:
            self.dt = min(self.dt, cfg.stop_time - self.time)
        # initial pressure iterations (varden.f90:460-490)
        self._hints = self._zero_hints()
        for _ in range(cfg.init_iter):
            st2, _diag = self._advance(state, projection.PRESSURE_ITERS)
            state = State(u=state.u, s=state.s, gp=st2.gp, p=st2.p)
        return state

    def step(self, state: State) -> State:
        """One regular timestep (varden.f90:237-371 loop body)."""
        cfg = self.cfg
        self.istep += 1
        if self.istep > 1:
            self.dt = advance.estdt(self.sim, state, self.dt)
            if cfg.fixed_dt > 0.0:
                self.dt = cfg.fixed_dt
            if cfg.stop_time >= 0.0 and self.time + self.dt > cfg.stop_time:
                self.dt = cfg.stop_time - self.time
        state, diag = self._advance(state, projection.REGULAR_TIMESTEP)
        self.time += self.dt
        self.last_diag = diag
        self._check_solver_health(diag)
        if cfg.verbose >= 1:
            print(f"... max of [div(umac)-RHS] before/after MAC projection "
                  f"{float(diag['div_before']):15.8e} "
                  f"{float(diag['div_after']):15.8e}")
            names = ("x", "y", "z")[:self.sim.dm]
            for tag in ("pre", "post"):
                when = "before" if tag == "pre" else " after"
                for d, nm in enumerate(names):
                    print(f"... {nm}-velocity {when} projection "
                          f"{float(diag['u_' + tag + '_min'][d]):17.10e}  "
                          f"{float(diag['u_' + tag + '_max'][d]):17.10e}")
            print(f"... new min/max : density {float(diag['smin']):17.10e} "
                  f"{float(diag['smax']):17.10e}")
        if cfg.mg_verbose >= 1:
            print(f"... solver resnorm: MAC {float(diag['mac_resnorm']):12.5e}"
                  f"  HG {float(diag['hg_resnorm']):12.5e}")
        print(f"STEP = {self.istep:4d}  TIME = {self.time:14.10f}  "
              f"DT = {self.dt:14.9f}")
        return state

    def _check_solver_health(self, diag):
        """Guard under-converged projection exits: solver_guard = k warns at
        residual > k x effective tolerance, 0 disables, negative raises
        (the reference's solvers abort on non-convergence)."""
        k = self.cfg.solver_guard
        if k == 0.0:
            return
        for nm in ("mac_ratio", "hg_ratio"):
            r = float(diag[nm])
            if r > abs(k):
                msg = (f"step {self.istep}: {nm.split('_')[0].upper()} "
                       f"projection exited {r:.1f}x above its effective "
                       f"tolerance (solver_guard={k})")
                if k < 0:
                    raise RuntimeError(msg)
                warnings.warn(msg)

    def run(self, state: Optional[State] = None,
            max_step: Optional[int] = None) -> State:
        cfg = self.cfg
        state = self.initialize(state)
        max_step = cfg.max_step if max_step is None else max_step
        while self.istep < max_step and (cfg.stop_time < 0.0 or
                                         self.time < cfg.stop_time - 1e-14):
            state = self.step(state)
        return state


def run_from_inputs(path: str, device=None, **overrides) -> Varden:
    """Load a reference-format inputs file (``overrides`` applied after
    it), run it to the end and return the Varden, its final state in
    ``final_state``."""
    cfg = load_config(path, **overrides)
    v = Varden(cfg, device=device)
    v.final_state = v.run()
    return v
