"""Main driver (counterpart of varden_tpu.driver): the reference's varden()
program flow (src/varden.f90:1-665) — init, initial projection, initial
pressure iterations, main step loop — on one level or on a non-subcycled AMR
hierarchy (max_levs > 1: adaptive or fixed grids, regrid every regrid_int
steps).

2-D and 3-D runs write plotfiles and checkpoints at plot_int / chk_int
(and at a final step off the cadence) and restart from a checkpoint
(restart >= 0), bitwise.

The device mesh (mesh > 0, varden_tpu/driver.py:68-94): with one rank in
the process group the run warns and runs unsharded, as varden_tpu does with
too few devices, the regridder keeping its mesh-quantised patch extents.
With mesh ranks (torch.distributed, parallel.mesh.maybe_init_distributed)
the run is decomposed: each rank holds its block of every field
(parallel.mesh.Decomp) and exchanges halos and reduces norms with the
others. A single-level run's Sim is the rank's block; a multi-level run
decomposes every patch of every level over the same ranks (fill.MLGeom,
the coarse-fine coupling through parallel.halo.fetch and put). Rank 0
alone writes plotfiles, checkpoints, job info and the grids file, and
every rank reads a checkpoint to restart. ``gather`` gives the whole State
(the list of whole patches of a multi-level run).
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from . import advance, problems, projection
from .amr import advance_ml, regrid
from .amr.fill import MLGeom
from .config import VardenConfig, load_config
from .io import output
from .parallel import halo
from .parallel import mesh as pmesh
from .solvers import nodal
from .state import Sim, State, resolve_device

# Hierarchies above this many cells keep only the last projection solutions
# as warm starts, not the '_prev' pair of the linear extrapolation (their
# memory at 256^3 + 2 levels).
WARM_EXTRAP_MAX_CELLS = 5e7


def _decomposition(cfg: VardenConfig, device):
    """(the rank's block of the base level, the number of ranks) of a
    decomposed run, or (None, 1): no mesh, or one rank."""
    if cfg.mesh <= 0:
        return None, 1
    pmesh.maybe_init_distributed(resolve_device(device))
    ranks = pmesh.world_size()
    if ranks == 1:
        warnings.warn(f"mesh={cfg.mesh} ranks requested but the process "
                      "group has 1; running unsharded")
        return None, 1
    if cfg.mesh != ranks:
        raise ValueError(f"mesh={cfg.mesh} but the process group has "
                         f"{ranks} ranks")
    dec = pmesh.make_decomp(cfg.n_cell, cfg.pmask, ranks, pmesh.rank())
    if not dec.keeps_blocks() or any(dec.n[d] < cfg.ng_cell
                                     for d in range(cfg.dm) if dec.split(d)):
        raise ValueError(f"{ranks} ranks cut {cfg.n_cell} cells into blocks "
                         f"of {dec.n}: a split axis needs an even block of "
                         f"at least {max(pmesh.MIN_BLOCK, cfg.ng_cell)}")
    return dec, ranks


def gather_states_ml(geom: MLGeom, states):
    """The whole patches' States on every rank from each rank's blocks of
    a decomposed multi-level run (exact); ``states`` themselves
    otherwise."""
    return [State(u=geom.gather(l, st.u), s=geom.gather(l, st.s),
                  gp=geom.gather(l, st.gp), p=geom.gather(l, st.p, True))
            for l, st in enumerate(states)]


def gather_state(sim: Sim, state: State) -> State:
    """The whole level's State on every rank from each rank's block where
    ``sim`` is decomposed (exact); ``state`` itself otherwise."""
    dec = sim.dec
    if dec is None:
        return state
    return State(u=halo.gather(state.u, dec), s=halo.gather(state.s, dec),
                 gp=halo.gather(state.gp, dec),
                 p=halo.gather(state.p, dec, nodal.node_extra(dec.local_pmask),
                               nodal.node_extra(dec.pmask)))


class Varden:
    """A configured simulation, single-level or (max_levs > 1) multi-level,
    on one device or (mesh > 0 in a process group of mesh ranks)
    decomposed over the group's ranks.

    ``device`` defaults to the card; with no card present the constructor
    raises unless ``device="cpu"`` is given (the plain PyTorch path)."""

    def __init__(self, cfg: VardenConfig, device=None):
        self.cfg = cfg
        dec, ranks = _decomposition(cfg, device)
        ml = cfg.max_levs > 1
        self.sim = Sim(cfg, device=device, decomp=None if ml else dec)
        if ml and ranks > 1:
            self.sim.ml_ranks = ranks
        self.time = 0.0
        self.dt = 1.0e20
        self.istep = 0
        self._hints = None
        self.last_diag = None
        self.ml = cfg.max_levs > 1
        self.geom = None          # MLGeom in multi-level mode
        self._ml_hints = None     # per-level projection warm starts
        self.regrids = 0          # regrids done (hierarchy kept or rebuilt)

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
        self._report(diag)
        return state

    def gather(self, state):
        """The whole level's State on every rank from each rank's block of
        a decomposed run (exact), or of a multi-level run the list of whole
        patches' States; ``state`` itself otherwise."""
        if self.ml:
            return gather_states_ml(self.geom, state)
        return gather_state(self.sim, state)

    def _report(self, diag, levels=""):
        """The step's diagnostics (verbose, mg_verbose) and banner (rank 0
        of a decomposed run)."""
        if not pmesh.is_io_proc():
            return
        cfg = self.cfg
        if cfg.verbose >= 1:
            print(f"... max of [div(umac)-RHS] before/after MAC projection "
                  f"{float(diag['div_before']):15.8e} "
                  f"{float(diag['div_after']):15.8e}")
            names = ("x", "y", "z")[:self.sim.dm]
            for tag in ("pre", "post"):
                if "u_" + tag + "_min" not in diag:
                    continue
                when = "before" if tag == "pre" else " after"
                for d, nm in enumerate(names):
                    print(f"... {nm}-velocity {when} projection "
                          f"{float(diag['u_' + tag + '_min'][d]):17.10e}  "
                          f"{float(diag['u_' + tag + '_max'][d]):17.10e}")
            print(f"... new min/max : density {float(diag['smin']):17.10e} "
                  f"{float(diag['smax']):17.10e}")
        if cfg.mg_verbose >= 1 and "mac_resnorm" in diag:
            print(f"... solver resnorm: MAC {float(diag['mac_resnorm']):12.5e}"
                  f"  HG {float(diag['hg_resnorm']):12.5e}")
        print(f"STEP = {self.istep:4d}  TIME = {self.time:14.10f}  "
              f"DT = {self.dt:14.9f}{levels}")

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

    def restart(self) -> State:
        """Resume from checkpoint chk<restart> (reference
        initialize_from_restart, src/initialize.f90:23-91; resumes at
        restart+1, varden.f90:225-229), warm starts included."""
        cfg = self.cfg
        name = f"{cfg.check_base_name}{cfg.restart:05d}"
        state, header, hints = output.read_checkpoint(self.sim, name)
        self.time, self.dt = header["time"], header["dt"]
        self.istep = header["istep"]
        if hints is not None:
            self._hints = hints
        return state

    def _running(self, max_step):
        cfg = self.cfg
        return self.istep < max_step and (cfg.stop_time < 0.0 or
                                          self.time < cfg.stop_time - 1e-14)

    def _due(self, every, final):
        """Whether a plotfile / checkpoint written every ``every`` steps is
        due now: on the cadence, or at a final step off it
        (varden.f90:378)."""
        return every > 0 and (self.istep % every == 0 or final)

    def run(self, state: Optional[State] = None,
            max_step: Optional[int] = None):
        """Run to max_step / stop_time, from initial data or (restart >= 0)
        from a checkpoint. Returns the final State, or in multi-level mode
        the list of per-patch States."""
        cfg = self.cfg
        if self.ml:
            return self.run_ml(max_step)
        if cfg.restart >= 0 and state is None:
            state = self.restart()
        else:
            state = self.initialize(state)
        max_step = cfg.max_step if max_step is None else max_step

        def write(final=False):
            if self._due(cfg.plot_int, final):
                output.write_plotfile(self.sim, state, self.istep, self.time,
                                      self.dt)
            if self._due(cfg.chk_int, final):
                output.write_checkpoint(self.sim, state, self.istep,
                                        self.time, self.dt,
                                        hints=self._hints)

        write()
        while self._running(max_step):
            state = self.step(state)
            write(final=not self._running(max_step))
        return state

    # -- multi-level ----------------------------------------------------
    def _hints_have_prev(self):
        """Whether the ML warm starts carry the '_prev' extrapolation pair
        (dropped on large hierarchies, see WARM_EXTRAP_MAX_CELLS)."""
        return self.geom.cells() <= WARM_EXTRAP_MAX_CELLS

    def _zero_ml_hints(self):
        sim, geom = self.sim, self.geom
        z_mac = [sim.zeros(geom.bn(l)) for l in range(geom.nlev)]
        z_hg = [sim.zeros(geom.bnode_shape(l)) for l in range(geom.nlev)]
        hints = {"phi_mac": z_mac, "phi_hg": z_hg}
        if self._hints_have_prev():
            hints["phi_mac_prev"] = [z.clone() for z in z_mac]
            hints["phi_hg_prev"] = [z.clone() for z in z_hg]
        return hints

    def _ml_advance(self, states, proj_type):
        """One ml_advance with the hint rotation (the new solutions become
        'phi_*', the old ones 'phi_*_prev' where those are kept)."""
        if self._ml_hints is None:
            self._ml_hints = self._zero_ml_hints()
        h = self._ml_hints
        new_states, diag = advance_ml.ml_advance(self.geom, states, self.dt,
                                                 proj_type, hints=h)
        new_h = {"phi_mac": diag.pop("phi_mac"), "phi_hg": diag.pop("phi_hg")}
        if "phi_mac_prev" in h:
            new_h["phi_mac_prev"] = h["phi_mac"]
            new_h["phi_hg_prev"] = h["phi_hg"]
        self._ml_hints = new_h
        return new_states, diag

    def initialize_ml(self):
        """Hierarchy init (adaptive or fixed grids), the initial projection
        and the initial pressure iterations (varden.f90:94-235 with
        nlevs > 1)."""
        cfg = self.cfg
        if cfg.fixed_grids:
            self.geom, states = regrid.initialize_fixed(self.sim)
        else:
            self.geom, states = regrid.initialize_adaptive(self.sim)
        if cfg.grids_file_name:
            regrid.write_grids(cfg.grids_file_name, self.geom, 0)
        if cfg.do_initial_projection > 0:
            u_l = [st.u for st in states]
            u, p, gp, _phi, _ratio, _outer = advance_ml.hgproject_ml(
                self.geom, projection.INITIAL_PROJECTION, u_l, u_l,
                [torch.ones_like(st.s[0]) for st in states],
                [st.p for st in states], [st.gp for st in states], 1.0)
            states = [State(u=u[l], s=states[l].s,
                            gp=torch.zeros_like(gp[l]),
                            p=torch.zeros_like(p[l]))
                      for l in range(len(states))]
        self.dt = advance_ml.ml_estdt(self.geom, states, -1.0) * \
            cfg.init_shrink
        if cfg.fixed_dt > 0.0:
            self.dt = cfg.fixed_dt
        if cfg.stop_time >= 0.0:
            self.dt = min(self.dt, cfg.stop_time - self.time)
        self._ml_hints = None
        for _ in range(cfg.init_iter):
            st2, _diag = self._ml_advance(states, projection.PRESSURE_ITERS)
            states = [State(u=states[l].u, s=states[l].s, gp=st2[l].gp,
                            p=st2[l].p) for l in range(len(states))]
        return states

    def _regrid_due(self, istep):
        cfg = self.cfg
        return (cfg.regrid_int > 0 and istep > 1 and not cfg.fixed_grids
                and (istep - 1) % cfg.regrid_int == 0)

    def _regrid(self, states):
        """Tag, cluster and rebuild the hierarchy (regrid.f90:20-272); the
        current one is kept when the new tree equals it, or (regrid_slack >
        0) while it still covers the new one (regrid_waste). Returns
        (states, whether the hierarchy was rebuilt)."""
        cfg = self.cfg
        specs, parent, depth = regrid.compute_tree(self.sim, self.geom,
                                                   states)
        new_geom = MLGeom(self.sim, specs, parent, depth)
        keep = (new_geom.key() == self.geom.key()
                or (cfg.regrid_slack > 0 and regrid.geom_covers(
                    self.geom, specs, parent, depth, cfg.regrid_waste)))
        self.regrids += 1
        if keep:
            return states, False
        states = regrid.build_level_data(self.sim, self.geom, states,
                                         new_geom)
        self.geom = new_geom
        self._ml_hints = None  # shapes changed: cold-start solves
        if cfg.grids_file_name:
            regrid.write_grids(cfg.grids_file_name, self.geom, self.istep)
        return states, True

    def _ml_dt(self, states, clip=True):
        """The step's dt (varden.f90:302-318), from the second step on;
        ``clip`` cuts it at stop_time."""
        cfg = self.cfg
        self.dt = advance_ml.ml_estdt(self.geom, states, self.dt)
        if cfg.fixed_dt > 0.0:
            self.dt = cfg.fixed_dt
        if clip and cfg.stop_time >= 0.0 and \
                self.time + self.dt > cfg.stop_time:
            self.dt = cfg.stop_time - self.time

    def step_ml(self, states):
        """One regular multi-level step: regrid when due, dt, ml_advance."""
        self.istep += 1
        note = ""
        if self._regrid_due(self.istep):
            states, rebuilt = self._regrid(states)
            note = "; regrid: " + ("rebuilt" if rebuilt else "kept")
        if self.istep > 1:
            self._ml_dt(states)
        states, diag = self._ml_advance(states, projection.REGULAR_TIMESTEP)
        self.time += self.dt
        self.last_diag = diag
        self._check_solver_health(diag)
        self._report(diag, f"  (levels: {[s.n for s in self.geom.specs]}"
                     f"{note})")
        return states

    def step_ml_chunk(self, states, k):
        """k regular steps on a fixed hierarchy (no regrid inside): the
        caller guarantees istep >= 1 and no regrid due within the chunk;
        stop_time clipping is the caller's too."""
        for _ in range(k):
            self.istep += 1
            self._ml_dt(states, clip=False)
            states, diag = self._ml_advance(states,
                                            projection.REGULAR_TIMESTEP)
            self.time += self.dt
            self.last_diag = diag
            self._check_solver_health(diag)
        self._report(self.last_diag, f"  (chunk of {k}; levels: "
                     f"{[s.n for s in self.geom.specs]})")
        return states

    def restart_ml(self):
        """Resume a multi-level run from checkpoint chk<restart>: the patch
        tree, the states and the warm starts (conformed to this run's hint
        structure: large hierarchies keep no '_prev' pair)."""
        cfg = self.cfg
        name = f"{cfg.check_base_name}{cfg.restart:05d}"
        self.geom, states, header, hints = output.read_checkpoint_ml(
            self.sim, name)
        self.time, self.dt = header["time"], header["dt"]
        self.istep = header["istep"]
        if hints is not None and not self._hints_have_prev():
            hints = {k: v for k, v in hints.items()
                     if not k.endswith("_prev")}
        self._ml_hints = hints
        return states

    def run_ml(self, max_step: Optional[int] = None):
        cfg = self.cfg
        states = (self.restart_ml() if cfg.restart >= 0
                  else self.initialize_ml())
        max_step = cfg.max_step if max_step is None else max_step

        def write(final=False):
            if self._due(cfg.plot_int, final):
                output.write_plotfile_ml(self.geom, states, self.istep,
                                         self.time)
            if self._due(cfg.chk_int, final):
                output.write_checkpoint_ml(self.geom, states, self.istep,
                                           self.time, self.dt,
                                           hints=self._ml_hints)

        write()
        while self._running(max_step):
            states = self.step_ml(states)
            write(final=not self._running(max_step))
        return states


def run_from_inputs(path: str, device=None, **overrides) -> Varden:
    """Load a reference-format inputs file (``overrides`` applied after
    it), run it to the end and return the Varden, its final state in
    ``final_state`` (a list of per-patch States in multi-level mode)."""
    cfg = load_config(path, **overrides)
    v = Varden(cfg, device=device)
    v.final_state = v.run()
    return v
