"""Inputs shared by the tests of varden_tpu_torch: made with numpy from a
seed, so that both packages (and the card) see the same numbers."""
import numpy as np
import pytest
import torch


def smooth(shape, seed, amp=0.5, dm=3):
    """A sum of three low sine modes over the last ``dm`` axes, one draw per
    leading index. The multigrid solvers converge on such fields at the rate
    the projections see, where white noise can stall their V-cycles, and a
    Godunov upwind choice on them flips only at roundoff-level ties."""
    rng = np.random.RandomState(seed)
    X = np.meshgrid(*[np.linspace(0.0, 1.0, s) for s in shape[-dm:]],
                    indexing="ij")
    out = np.zeros(shape)
    for idx in np.ndindex(*shape[:-dm]):
        f = np.zeros(shape[-dm:])
        for _ in range(3):
            k, ph = rng.randint(1, 4, size=dm), rng.rand(dm) * 2 * np.pi
            f += np.prod([np.sin(k[d] * np.pi * X[d] + ph[d])
                          for d in range(dm)], axis=0)
        out[idx] = amp * f / 3.0
    return out


def state_arrays(states):
    """Per-patch dicts of numpy arrays (u, s, gp, p) of a list of States of
    either package."""
    return [{k: np.array(getattr(st, k)) for k in ("u", "s", "gp", "p")}
            for st in states]


def two_blob_rho(n, dx, centers, radius=0.08):
    """A density of 1 plus tanh blobs of height 1 at ``centers`` on a grid
    of n cells of width dx (any dimension)."""
    X = np.meshgrid(*[(np.arange(n[d]) + 0.5) * dx[d] for d in range(len(n))],
                    indexing="ij")
    rho = np.ones(n)
    for c in centers:
        r = np.sqrt(sum((X[d] - c[d]) ** 2 for d in range(len(n))))
        rho += 0.5 * (1.0 - np.tanh((r - radius) / 0.02))
    return rho


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's plain-path tensors on one thread: at the tests' small
    sizes a thread pool only contends with the other test processes.
    Imported by the modules that use it; the pool size is restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The compile options of the varden_tpu references that the tests jit
# themselves (ref_jit): XLA's backend at optimisation level 0 compiles such
# a reference about a third faster on the CPU, and each runs once or a few
# times at the tests' small sizes.
REF_COMPILE = {"xla_backend_optimization_level": 0}


def ref_jit(fn, **kw):
    """jax.jit with REF_COMPILE, for a varden_tpu reference that a test
    jits itself (also as a decorator)."""
    import jax
    return jax.jit(fn, compiler_options=REF_COMPILE, **kw)


def force_padded_route(monkeypatch):
    """Make varden_tpu take its accelerator route to the padded sweep
    (pallas_kernels.gsrb_sweep_3d, run in interpret mode) on the levels
    where it takes it on the TPU: 3-D, face-tensor beta, x periodic (where
    gsrb_var_sweep_3d refuses), every extent even and >= 8 (gsrb_supported
    without its VMEM clause). Returns a list that counts the sweeps."""
    import functools
    from varden_tpu.bc import BC_PER
    from varden_tpu.ops import pallas_kernels as pk
    calls = []
    sweep = functools.partial(pk.gsrb_sweep_3d, interpret=True)

    def supported(level):
        return (level.dm == 3
                and all(getattr(b, "ndim", 0) > 0 for b in level.beta)
                and BC_PER in level.ell_bc[0]
                and all(s >= 8 and s % 2 == 0 for s in level.n))

    def counted(*a, **k):
        calls.append(1)
        return sweep(*a, **k)

    monkeypatch.setattr(pk, "gsrb_supported", supported)
    monkeypatch.setattr(pk, "gsrb_sweep_3d", counted)
    return calls


def run_inputs_both(path, **over):
    """Run an inputs file through both packages on the CPU in float64 with
    the given overrides (no plotfiles, no checkpoints, quiet): returns
    (varden_tpu driver, port driver, varden_tpu states, port states), the
    states as a list of patches."""
    from varden_tpu.config import load_config as jload
    from varden_tpu.driver import Varden as JVarden
    from varden_tpu_torch.config import load_config as tload
    from varden_tpu_torch.driver import Varden as TVarden
    over = dict(dict(dtype="float64", plot_int=-1, chk_int=-1, verbose=0),
                **over)
    jv, tv = JVarden(jload(path, **over)), TVarden(tload(path, **over),
                                                   device="cpu")
    js, ts = jv.run(), tv.run()
    if not isinstance(js, (list, tuple)):
        js, ts = [js], [ts]
    return jv, tv, list(js), list(ts)


def assert_runs_agree(jv, tv, js, ts, tol=1e-9):
    """Both runs took the same steps, times and (multi-level) boxes, and
    every field of every patch agrees to ``tol`` of the field's size."""
    assert tv.istep == jv.istep
    assert abs(tv.time - jv.time) <= 1e-12 * jv.time
    if getattr(jv, "geom", None) is not None and len(js) > 1:
        assert [(tuple(s.lo), tuple(s.n)) for s in tv.geom.specs] == \
            [(tuple(s.lo), tuple(s.n)) for s in jv.geom.specs]
        assert list(tv.geom.parent) == list(jv.geom.parent)
    agree(state_arrays(ts), state_arrays(js), tol)


def field_deltas(got, ref):
    """Each field's largest |got - ref| over every patch, in units of the
    field's size (max(1, max |ref|)), of two lists of patches' dicts of
    numpy arrays (state_arrays): {field: delta}; inf where either side
    holds a value that is not finite, so that no NaN passes a bound."""
    out = {}
    for a, b in zip(got, ref):
        for k in a:
            if np.isfinite(a[k]).all() and np.isfinite(b[k]).all():
                scale = max(1.0, float(np.abs(b[k]).max()))
                d = float(np.abs(a[k] - b[k]).max()) / scale
            else:
                d = float("inf")
            out[k] = max(out.get(k, 0.0), d)
    return out


def agree(got, ref, tol):
    """Every field of every patch of ``got`` and ``ref`` is finite, and
    ``got`` is within ``tol`` of the field's size of ``ref``
    (field_deltas)."""
    assert len(got) == len(ref)
    for k, d in field_deltas(got, ref).items():
        assert d <= tol, (k, d)


def row_ranges(rho, pmask, lo=None, dom=None):
    """The density's range in each wall row (the first and the last cell
    row along every non-periodic axis, named like "z=0" and "z=63") and in
    the interior (the cells two or more rows from every wall), of a numpy
    array and the level's periodic mask: {name: (min, max)}. For a patch
    at ``lo`` on a level of ``dom`` cells, only the rows on the domain's
    walls count, named by their index on the level."""
    rho = np.asarray(rho)
    lo = (0,) * rho.ndim if lo is None else tuple(lo)
    dom = rho.shape if dom is None else tuple(dom)
    out, inner = {}, [slice(None)] * rho.ndim
    for d in range(rho.ndim):
        if pmask[d]:
            continue
        n = rho.shape[d]
        for i, wall in ((0, lo[d] == 0), (n - 1, lo[d] + n == dom[d])):
            if wall:
                row = np.take(rho, i, axis=d)
                out[f"{'xyz'[d]}={lo[d] + i}"] = (float(row.min()),
                                                  float(row.max()))
        inner[d] = slice(2 if lo[d] == 0 else 0,
                         n - 2 if lo[d] + n == dom[d] else n)
    core = rho[tuple(inner)]
    if core.size:
        out["interior"] = (float(core.min()), float(core.max()))
    return out


def regularise_reference(mp):
    """Patch varden_tpu's composite nodal solve (through the MonkeyPatch
    ``mp``) as the port builds it: a fine level that fixes no node (no
    coarse-fine side, no outlet: decided from the geometry, as the masks
    are traced under jit) gets its multigrid hierarchy built with mask
    None (ROADMAP.md section 3, the three-level departure). Returns the
    list of the masks so freed."""
    from varden_tpu.amr import solve as jsolve
    from varden_tpu.config import OUTLET
    free = []
    mask_fn, build = jsolve.fine_nodal_mask, jsolve.nodal.build_hierarchy

    def fine_nodal_mask(geom, lev, extra_mask=None):
        mask = mask_fn(geom, lev, extra_mask)
        fixed = any(geom.side_kind(lev, d, side) == "cf" or (
            geom.side_kind(lev, d, side) == "phys"
            and geom.sim.phys_bc[d][side] == OUTLET)
            for d in range(geom.dm) for side in range(2))
        if not fixed and extra_mask is None:
            free.append(mask)
        return mask

    def build_hierarchy(n, dx, pmask, sigma, mask=None, *a, **k):
        if any(mask is m for m in free):
            mask = None
        return build(n, dx, pmask, sigma, mask, *a, **k)

    mp.setattr(jsolve, "fine_nodal_mask", fine_nodal_mask)
    mp.setattr(jsolve.nodal, "build_hierarchy", build_hierarchy)
    return free


class RefStep:
    """varden_tpu's jitted single-level regular step (Varden._step, the
    ``_step_impl`` of varden_tpu/driver.py:39-60): ``cfg`` is a varden_tpu
    VardenConfig. ``__call__(arrays, dt, hints)`` takes a state's dict of
    numpy arrays (state_arrays), the step's dt and the warm starts
    ({"phi_mac", "phi_mac_prev", "phi_hg", "phi_hg_prev"}) and returns the
    new state's arrays. Its compile also serves the whole run of ``v``."""

    def __init__(self, cfg):
        from varden_tpu.driver import Varden as JVarden
        self.v = JVarden(cfg)

    def __call__(self, arrays, dt, hints):
        import jax.numpy as jnp
        from varden_tpu import projection as jproj
        from varden_tpu.state import State as JState
        st = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
        h = {k: jnp.asarray(v) for k, v in hints.items()}
        out, _h, _diag = self.v._step[jproj.REGULAR_TIMESTEP](st, dt, h)
        return state_arrays([out])[0]


def hold_port_run(path, tol=1e-9, at=None, report=None, **over):
    """Run an inputs file through the port's multi-level driver on the CPU
    in float64 (no plotfiles, no checkpoints, quiet) and hold it to
    varden_tpu step by step, without varden_tpu's whole run (one compile
    of its multi-level step per hierarchy, minutes on the CPU): the
    initial hierarchy and data equal varden_tpu's initialize_adaptive;
    at every regrid varden_tpu's compute_tree on the port's states gives
    the port's new tree (kept or rebuilt) and build_level_data the port's
    new data (1e-12 of each field's size); and varden_tpu's ml_advance
    (under jax.jit, one compile a hierarchy), from the port's state, dt and
    warm starts of a regular step, gives the port's result within ``tol``
    of each field's size. The steps so held are those numbered in ``at``
    (regular steps counted from 1), the last one by default. With
    ``report``, each held step calls report(step, field_deltas, port's
    arrays, varden_tpu's arrays, the port's MLGeom) and its agreement is
    not asserted.
    Returns (the port's driver, its final states, the patches' (lo, n)
    after every step)."""
    import jax
    import jax.numpy as jnp
    from varden_tpu.amr import advance_ml as jadv
    from varden_tpu.amr import fill as jfill
    from varden_tpu.amr import hierarchy as jh
    from varden_tpu.amr import regrid as jregrid
    from varden_tpu.config import load_config as jload
    from varden_tpu.state import Sim as JSim
    from varden_tpu.state import State as JState
    from varden_tpu_torch import projection
    from varden_tpu_torch.amr import advance_ml as tadv
    from varden_tpu_torch.amr import regrid as tregrid
    from varden_tpu_torch.config import load_config as tload
    from varden_tpu_torch.driver import Varden as TVarden
    over = dict(dict(dtype="float64", plot_int=-1, chk_int=-1, verbose=0,
                     mg_verbose=0), **over)
    jsim = JSim(jload(path, **over))
    inits, regrids, steps, boxes = [], [], [], []
    want = None if at is None else set(at)
    count = [0]

    def tree(geom):
        return ([(tuple(int(i) for i in s.lo), tuple(int(i) for i in s.n))
                 for s in geom.specs], list(geom.parent), list(geom.depth))

    def jgeom(geom):
        return jfill.MLGeom(jsim, [jh.LevelSpec(tuple(s.lo), tuple(s.n))
                                   for s in geom.specs], list(geom.parent),
                            list(geom.depth))

    def jstates(arrays):
        return [JState(**{k: jnp.asarray(v) for k, v in a.items()})
                for a in arrays]

    init, regrid_fn, step_ml = (tregrid.initialize_adaptive, TVarden._regrid,
                                TVarden.step_ml)
    advance = tadv.ml_advance

    def spied_init(sim):
        geom, states = init(sim)
        inits.append((tree(geom), state_arrays(states)))
        return geom, states

    def spied_regrid(self, states):
        before = (self.geom, state_arrays(states))
        states, rebuilt = regrid_fn(self, states)
        regrids.append((before, tree(self.geom), rebuilt,
                        state_arrays(states)))
        return states, rebuilt

    def spied_step(self, states):
        states = step_ml(self, states)
        boxes.append((self.istep, tree(self.geom)[0]))
        return states

    def spied_advance(geom, states, dt, proj_type, hints=None):
        if proj_type != projection.REGULAR_TIMESTEP:
            return advance(geom, states, dt, proj_type, hints=hints)
        count[0] += 1
        if want is not None and count[0] not in want:
            return advance(geom, states, dt, proj_type, hints=hints)
        entry = dict(step=count[0], geom=geom, states=state_arrays(states),
                     dt=float(dt), proj_type=proj_type,
                     hints={k: [t.numpy().copy() for t in v]
                            for k, v in (hints or {}).items()})
        out = advance(geom, states, dt, proj_type, hints=hints)
        entry["out"] = state_arrays(out[0])
        if want is None:
            steps[:] = [entry]
        else:
            steps.append(entry)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tregrid, "initialize_adaptive", spied_init)
        mp.setattr(TVarden, "_regrid", spied_regrid)
        mp.setattr(TVarden, "step_ml", spied_step)
        mp.setattr(tadv, "ml_advance", spied_advance)
        tv = TVarden(tload(path, **over), device="cpu")
        ts = tv.run()

    (ttree, tarrays), = inits
    jg0, js0 = jregrid.initialize_adaptive(jsim)
    assert ttree == tree(jg0)
    agree(tarrays, state_arrays(js0), 1e-12)
    for (old_geom, old), new_tree, rebuilt, new in regrids:
        jg = jgeom(old_geom)
        specs, parent, depth = jregrid.compute_tree(jsim, jg, jstates(old))
        jnew = jfill.MLGeom(jsim, specs, parent, depth)
        assert new_tree == tree(jnew if rebuilt else jg)
        assert rebuilt == (jnew.key() != jg.key())
        if rebuilt:
            agree(new, state_arrays(jregrid.build_level_data(
                jsim, jg, jstates(old), jnew)), 1e-12)
    assert steps and (want is None or len(steps) == len(want))
    fns = {}
    for step in steps:
        key = (repr(tree(step["geom"])), step["proj_type"])
        if key not in fns:
            jg = jgeom(step["geom"])
            fns[key] = ref_jit(lambda st, dt, h, _g=jg, _pt=step["proj_type"]:
                               jadv.ml_advance(_g, st, dt, _pt, hints=h))
        hints = {k: [jnp.asarray(v) for v in vs]
                 for k, vs in step["hints"].items()}
        jout, _jdiag = fns[key](jstates(step["states"]), step["dt"], hints)
        ref = state_arrays(jout)
        if report is None:
            agree(step["out"], ref, tol)
        else:
            report(step["step"], field_deltas(step["out"], ref),
                   step["out"], ref, step["geom"])
    return tv, ts, boxes


CYCLES = {"port": [], "ref": []}


def spy_cycles(mp):
    """Record the V-cycles and ratio of every single-level solve
    (solvers.mg.solve, solvers.nodal.solve) of both packages, through the
    MonkeyPatch ``mp``, into CYCLES: {"port": [...], "ref": [...]}, lists of
    ("mg" or "nodal", cycles, ratio) in call order. varden_tpu's come from
    jax.debug.callback, so a step traced under the spy records them for
    as long as it is called. Returns CYCLES."""
    import jax
    from varden_tpu.solvers import mg as jmg
    from varden_tpu.solvers import nodal as jnodal
    from varden_tpu_torch.solvers import mg as tmg
    from varden_tpu_torch.solvers import nodal as tnodal

    def spy(mod, name, side):
        orig = mod.solve

        def solve(*a, return_info=False, **k):
            phi, info = orig(*a, return_info=True, **k)
            rn, iters, ratio = info
            if side == "ref":
                jax.debug.callback(
                    lambda i, r: CYCLES["ref"].append(
                        (name, int(i), float(r))), iters, ratio)
            else:
                CYCLES["port"].append((name, int(iters), float(ratio)))
            return (phi, info) if return_info else (phi, rn)
        mp.setattr(mod, "solve", solve)

    spy(jmg, "mg", "ref")
    spy(jnodal, "nodal", "ref")
    spy(tmg, "mg", "port")
    spy(tnodal, "nodal", "port")
    return CYCLES


def save_port_state(path, tv, state):
    """Write a single-level port run's state, warm starts, step, time and
    dt (``tv`` its driver after ``state``) to the .npz file ``path``, for
    start_port_state."""
    arrays = dict(state_arrays([state])[0], istep=tv.istep, time=tv.time,
                  dt=tv.dt)
    arrays.update({"hint_" + k: v.numpy() for k, v in tv._hints.items()})
    np.savez_compressed(path, **arrays)


def start_port_state(tv, path):
    """Set the port's single-level driver ``tv`` to the step, time, dt and
    warm starts that save_port_state wrote to ``path``, and return the
    State (on the CPU), from which tv.step goes on as the saved run did."""
    from varden_tpu_torch.state import State as TState
    with np.load(path) as z:
        tv.istep, tv.time, tv.dt = int(z["istep"]), float(z["time"]), \
            float(z["dt"])
        tv._hints = {k[5:]: torch.from_numpy(z[k].copy())
                     for k in z.files if k.startswith("hint_")}
        return TState(**{k: torch.from_numpy(z[k].copy())
                         for k in ("u", "s", "gp", "p")})


def shadow_single(cfgs, steps, shadow=(), whole=True, report=None,
                  ref=None, start=None):
    """Run a single-level configuration through the port on the CPU and hold
    it to varden_tpu, which takes the port's route to the padded red-black
    sweep (force_padded_route). ``cfgs`` is (the port's VardenConfig,
    varden_tpu's). Runs the port to step ``steps``; at every step in
    ``shadow`` hands the port's pre-step state, dt and warm starts to
    varden_tpu's jitted step (RefStep) and measures the field_deltas of the
    results; with ``whole`` runs varden_tpu's own run alongside from the
    same initial state, on the same compile, and measures the field_deltas
    of the two runs each step. Each step gives a record: step, time, dt,
    the density's row_ranges of the port ("port") and of varden_tpu's run
    ("ref"), "run" and "shadow" deltas, and the solves' (kind, cycles,
    ratio) of both ("cycles"). ``ref``, a RefStep of an earlier call, saves
    its compile. With ``start``, a file of save_port_state, the port goes
    on from the state saved there (and ``whole`` must be False). Calls
    report(record) each step; returns the records."""
    import contextlib
    import io

    import jax
    from varden_tpu_torch.driver import Varden as TVarden
    tcfg, jcfg = cfgs
    shadow, records = set(shadow), []
    with pytest.MonkeyPatch.context() as mp:
        cycles = spy_cycles(mp)
        force_padded_route(mp)
        ref = RefStep(jcfg) if ref is None else ref
        jv = ref.v
        tv = TVarden(tcfg, device="cpu")
        quiet = contextlib.redirect_stdout(io.StringIO())
        if start is not None:
            assert not whole
            tstate = start_port_state(tv, start)
        with quiet:
            if start is None:
                tstate = tv.initialize()
            jv.istep, jv.time, jv._hints = 0, 0.0, None
            jstate = jv.initialize() if whole else None
        while tv.istep < steps:
            cycles["port"].clear()
            pre = state_arrays([tstate])[0]
            hints = {k: v.numpy().copy() for k, v in tv._hints.items()}
            with quiet:
                tstate = tv.step(tstate)
            tarr = state_arrays([tstate])[0]
            rec = dict(step=tv.istep, time=tv.time, dt=tv.dt,
                       port=row_ranges(tarr["s"][0], tcfg.pmask),
                       cycles={"port": list(cycles["port"])})
            if tv.istep in shadow:
                cycles["ref"].clear()
                jarr = ref(pre, tv.dt, hints)
                jax.effects_barrier()
                rec["shadow"] = field_deltas([tarr], [jarr])
                rec["cycles"]["shadow"] = list(cycles["ref"])
            if whole:
                cycles["ref"].clear()
                with quiet:
                    jstate = jv.step(jstate)
                jarr = state_arrays([jstate])[0]
                jax.effects_barrier()
                rec.update(ref=row_ranges(jarr["s"][0], tcfg.pmask),
                           run=field_deltas([tarr], [jarr]))
                rec["cycles"]["ref"] = list(cycles["ref"])
            records.append(rec)
            if report is not None:
                report(rec)
    return records
