"""The cases of tests/test_torch_decomp.py: each runs on one rank (no
process group: the one-rank reference) or on every rank of a gloo group
started by varden_tpu_torch.parallel.launch, where rank 0 returns the
gathered result. Only torch and numpy are imported here, so that the
spawned ranks start quickly."""
import collections
import math

import numpy as np
import torch
import torch.distributed as dist

from torch_inputs import smooth
from varden_tpu_torch import advance, bc, problems, profiling, projection
from varden_tpu_torch.config import VardenConfig
from varden_tpu_torch.driver import Varden, gather_state
from varden_tpu_torch.parallel import halo
from varden_tpu_torch.parallel.mesh import make_decomp
from varden_tpu_torch.solvers import mg, nodal
from varden_tpu_torch.state import Sim, State

WALLS2 = dict(bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15)
WALLS3 = dict(WALLS2, bcz_lo=15, bcz_hi=15)
PERIODIC3 = dict(bcx_lo=-1, bcx_hi=-1, bcy_lo=-1, bcy_hi=-1, bcz_lo=-1,
                 bcz_hi=-1)

# the cases of tests/test_sharding.py, and a walled viscous 3-D bubble
STEP_CFGS = {
    "bubble2d": dict(dim_in=2, prob_type=1, n_cellx=32, n_celly=32,
                     grav=-9.8, visc_coef=1e-3, dtype="float64", **WALLS2),
    "periodic3d": dict(dim_in=3, prob_type=4, n_cellx=16, n_celly=16,
                       n_cellz=16, dtype="float64", **PERIODIC3),
    "visc3d": dict(dim_in=3, prob_type=1, n_cellx=16, n_celly=16,
                   n_cellz=16, grav=-9.8, visc_coef=1e-3, dtype="float64",
                   **WALLS3),
}
INLET_CFG = dict(dim_in=2, prob_type=2, n_cellx=32, n_celly=32,
                 bcx_lo=11, bcx_hi=12, bcy_lo=14, bcy_hi=14,
                 u_bc=((1.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
                 rho_bc=((1.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
                 max_step=2, init_iter=1, init_shrink=0.5, dtype="float64")
STEP_DT = 5e-3
STEPS = 2

CYCLES = collections.Counter()


def count_cycles():
    """Count the V-cycles that mg and nodal enter at their finest level."""
    for module, key, lev_pos in ((mg, "mg", 4), (nodal, "nodal", 3)):
        if getattr(module.v_cycle, "counted", False):
            continue
        fn = module.v_cycle

        def wrapped(*a, _fn=fn, _key=key, _pos=lev_pos, **k):
            if k.get("lev", a[_pos] if len(a) > _pos else 0) == 0:
                CYCLES[_key] += 1
            return _fn(*a, **k)

        wrapped.counted = True
        module.v_cycle = wrapped


def _rank():
    return dist.get_rank() if dist.is_initialized() else 0


def _decomp(n, pmask, nranks):
    return None if nranks == 1 else make_decomp(n, pmask, nranks, _rank())


def _np(t):
    return t.detach().cpu().numpy()


def _block(g, dec, nodal_=False):
    return g if dec is None else dec.block(g, nodal_)


def _faces(g, dec, d):
    """A rank's faces along axis d of a face tensor of the whole level."""
    if dec is None:
        return g
    for t in range(dec.dm):
        if dec.split(t):
            g = g.narrow(g.ndim - dec.dm + t, dec.lo[t],
                         dec.n[t] + (1 if t == d else 0))
    return g


def _gather(x, dec, nodes=False):
    if dec is None:
        return x
    if not nodes:
        return halo.gather(x, dec)
    return halo.gather(x, dec, nodal.node_extra(dec.local_pmask),
                       nodal.node_extra(dec.pmask))


# ---------------------------------------------------------------------------
# exchange, ghost fills, estdt: bit for bit

def _wrap_pad(g, k, shared):
    """The whole level grown by k on every axis by periodic wrap (a face
    or node axis: the shared end entry counted once)."""
    for d in range(g.ndim):
        n = g.shape[d] - (1 if shared[d] else 0)
        lo = g.narrow(d, n - k, k)
        hi = g.narrow(d, 1 if shared[d] else 0, k)
        g = torch.cat([lo, g, hi], dim=d)
    return g


def case_halo(nranks):
    """max |extend(block) - the wrapped whole level's slice|, cells and
    face tensors, 2-D and 3-D."""
    err = 0.0
    for n, pm in (((12, 16), (True, False)), ((8, 12, 6), (True, True, False)),
                  ((8, 8, 6), (False, False, True))):
        dec = make_decomp(n, pm, nranks, _rank())
        dm = len(n)
        for axis in (None,) + tuple(range(dm)):
            shared = [t == axis for t in range(dm)]
            shape = [s + (1 if sh else 0) for s, sh in zip(n, shared)]
            g = torch.arange(float(math.prod(shape))).reshape(shape)
            loc = g
            for t in range(dm):
                if dec.split(t):
                    loc = loc.narrow(t, dec.lo[t],
                                     dec.n[t] + (1 if shared[t] else 0))
            ext = halo.extend(loc, dec, 2, shared)
            ref = _wrap_pad(g, 2, shared)
            for t in range(dm):
                lo = dec.lo[t] + 2 - (2 if dec.internal(t, 0) else 0)
                ln = ext.shape[t]
                ref = ref.narrow(t, lo if dec.split(t) else 2, ln)
            err = max(err, float((ext - ref).abs().max()))
            back = halo.crop(ext, dec, 2)
            err = max(err, float((back - loc).abs().max()))
    return err


FILL_CODES = (bc.EXT_DIR, bc.FOEXTRAP, bc.HOEXTRAP, bc.REFLECT_EVEN,
              bc.REFLECT_ODD)


def case_fill(nranks):
    """max |decomposed fill_ghost - the whole level's fill sliced| over
    every recipe code on each side, periodic axes included (2-D 16x16 and
    3-D 8x8x8, ng = 3), and the same for grow_mac."""
    rng = np.random.RandomState(11)
    err = 0.0
    ng = 3
    for dm, n in ((2, (16, 16)), (3, (8, 8, 8))):
        for pm in ((False,) * dm, (True,) + (False,) * (dm - 1),
                   (True,) * dm, (False, True) + (False,) * (dm - 2)):
            dec = make_decomp(n, pm, nranks, _rank())
            lpm = dec.local_pmask
            for i, code in enumerate(FILL_CODES):
                codes = [[code, FILL_CODES[(i + d + 1) % 5]]
                         for d in range(dm)]
                codes = [[bc.ADV_INTERIOR] * 2 if pm[d] else codes[d]
                         for d in range(dm)]
                vals = rng.randn(dm, 2).tolist()
                g = torch.tensor(rng.randn(2, *n))
                full = bc.fill_ghost(g, ng, codes, vals, pm, dm)
                part = bc.fill_ghost(dec.block(g), ng, codes, vals, lpm, dm,
                                     dec=dec)
                ref = full
                for d in range(dm):
                    ref = ref.narrow(1 + d, dec.lo[d], dec.n[d] + 2 * ng)
                err = max(err, float((part - ref).abs().max()))
            umac = [torch.tensor(rng.randn(*[s + (1 if t == d else 0)
                                             for t, s in enumerate(n)]))
                    for d in range(dm)]
            full = bc.grow_mac(umac, 1, pm)
            part = bc.grow_mac([_faces(u, dec, d) for d, u in enumerate(umac)],
                               1, lpm, dec=dec)
            for d in range(dm):
                ref = full[d]
                for t in range(dm):
                    ref = ref.narrow(t, dec.lo[t], part[d].shape[t])
                err = max(err, float((part[d] - ref).abs().max()))
    return err


def case_estdt(nranks):
    """estdt of the 2-D bubble with a random velocity and pressure
    gradient, decomposed and whole."""
    cfg = VardenConfig(**STEP_CFGS["bubble2d"])
    dec = _decomp(cfg.n_cell, cfg.pmask, nranks)
    sim = Sim(cfg, device="cpu", decomp=dec)
    rng = np.random.RandomState(5)
    u = torch.tensor(rng.randn(2, 32, 32))
    gp = torch.tensor(rng.randn(2, 32, 32))
    st = problems.initdata(sim)
    st.u, st.gp = _block(u, dec), _block(gp, dec)
    return advance.estdt(sim, st, 1.0e20)


# ---------------------------------------------------------------------------
# solvers

def _mg_problem(case):
    rng = np.random.RandomState(3)
    B = mg.BC_DIR, mg.BC_NEU, mg.BC_PER
    if case == "face2d":
        n, ell, pm = (32, 32), ((B[1], B[1]), (B[1], B[0])), (False, False)
    elif case == "padded3d":
        n, ell, pm = (16, 16, 16), ((B[2], B[2]),) * 3, (True,) * 3
    else:   # const3d
        n, ell = (16, 16, 16), ((B[0], B[0]), (B[2], B[2]), (B[1], B[1]))
        pm = (False, True, False)
    dm = len(n)
    dx = [1.0 / s for s in n]
    rho = torch.tensor(1.0 + rng.rand(*n))
    if case == "const3d":
        return (n, dx, ell, pm, rho, (0.02,) * dm, 1.0,
                torch.tensor(rng.randn(3, *n)))
    beta = []
    for d in range(dm):
        shape = list(n)
        shape[d] += 1
        b = torch.tensor(1.0 / (1.0 + rng.rand(*shape)))
        if pm[d]:   # periodic faces: the last is the first
            b.narrow(d, n[d], 1).copy_(b.narrow(d, 0, 1))
        beta.append(b)
    return (n, dx, ell, pm, torch.zeros(n), tuple(beta), 0.0,
            torch.tensor(rng.randn(*n)))


def case_mg(nranks, case):
    """mg.solve of a MAC-like 2-D problem (face beta, walls, one Dirichlet
    face), the all-periodic 3-D one (kernel 7's frozen-ring levels) or a
    batch of three 3-D Helmholtz problems (kernel 5): (phi, cycles)."""
    n, dx, ell, pm, aco, beta, alpha, rhs = _mg_problem(case)
    dec = _decomp(n, pm, nranks)
    if dec is not None:
        aco, rhs = dec.block(aco), dec.block(rhs)
        beta = tuple(b if alpha else _faces(b, dec, d)
                     for d, b in enumerate(beta))
    phi, (rn, cycles, _ratio) = mg.solve(
        dec.n if dec else n, dx, ell, aco, beta, rhs, alpha=alpha,
        rel_eps=1e-10, return_info=True, dec=dec)
    return _np(_gather(phi, dec)), cycles, float(rn)


def case_nodal(nranks, case):
    """nodal.solve with walls (2-D), periodic axes (3-D) or an outlet
    face's Dirichlet nodes (3-D): (phi, cycles)."""
    rng = np.random.RandomState(4)
    if case == "walls2d":
        n, pm = (32, 32), (False, False)
    elif case == "periodic3d":
        n, pm = (16, 16, 16), (True, True, False)
    else:
        n, pm = (16, 16, 16), (False, False, True)
    dx = [1.0 / s for s in n]
    sigma = torch.tensor(1.0 / (1.0 + rng.rand(*n)))
    ns = nodal.node_shape(n, pm)
    rhs = torch.tensor(rng.randn(*ns))
    mask = None
    if case == "outlet3d":
        mask = torch.ones(ns)
        mask[-1] = 0.0
    dec = _decomp(n, pm, nranks)
    if dec is not None:
        sigma, rhs = dec.block(sigma), dec.block(rhs, True)
        mask = None if mask is None else dec.block(mask, True)
    phi, (rn, cycles, _ratio) = nodal.solve(
        dec.n if dec else n, dx, dec.local_pmask if dec else pm, sigma, rhs,
        mask=mask, rel_eps=1e-10, return_info=True, dec=dec)
    return _np(_gather(phi, dec, nodes=True)), cycles, float(rn)


# ---------------------------------------------------------------------------
# steps and runs

def case_steps(nranks, name):
    """STEPS regular steps of STEP_DT from the initial data (the
    tests/test_sharding.py pair): the fields and the V-cycles entered."""
    count_cycles()
    CYCLES.clear()
    cfg = VardenConfig(**STEP_CFGS[name])
    dec = _decomp(cfg.n_cell, cfg.pmask, nranks)
    sim = Sim(cfg, device="cpu", decomp=dec)
    state = problems.initdata(sim)
    for _ in range(STEPS):
        state, _diag = advance.advance_timestep(sim, state, STEP_DT,
                                                projection.REGULAR_TIMESTEP)
    return gather_state(sim, state), dict(CYCLES)


def case_inlet(nranks):
    """The 2-D inlet/outlet driver run (test_sharding's mesh mode)."""
    count_cycles()
    CYCLES.clear()
    v = Varden(VardenConfig(**INLET_CFG, mesh=nranks if nranks > 1 else 0,
                            verbose=0), device="cpu")
    state = v.gather(v.run())
    return state, dict(CYCLES), v.time


def case_debug(nranks):
    """The viscous 3-D bubble at 16^3 with use_godunov_debug, its velocity
    perturbed by a seeded field: profiling.phase_fns' four phases on that
    state (premac's and mac's faces, scalar's snew, hg's velocity), the
    phase keys of profile_phases, then STEPS steps of the oracle's
    route."""
    cfg = VardenConfig(**dict(STEP_CFGS["visc3d"], use_godunov_debug=True))
    dec = _decomp(cfg.n_cell, cfg.pmask, nranks)
    sim = Sim(cfg, device="cpu", decomp=dec)
    whole = problems.initdata(Sim(cfg, device="cpu"))
    u = whole.u + torch.as_tensor(smooth(tuple(whole.u.shape), 5, 0.3))
    state = State(u=_block(u, dec), s=_block(whole.s, dec),
                  gp=_block(whole.gp, dec), p=_block(whole.p, dec, True))
    f = profiling.phase_fns(sim)
    umac = f["premac"](state, STEP_DT)
    umac2 = f["mac"](state, umac)[0]
    snew = f["scalar"](state, umac2, STEP_DT)
    unew = f["hg"](state, snew, STEP_DT)[0]

    def faces(um):
        if dec is None:
            return [_np(x) for x in um]
        return [_np(halo.gather(x, dec, *[[int(t == d) for t in range(3)]]
                                * 2)) for d, x in enumerate(um)]

    out = {"premac": faces(umac), "mac": faces(umac2),
           "scalar": _np(_gather(snew, dec)), "hg": _np(_gather(unew, dec)),
           "keys": list(profiling.profile_phases(sim, state, STEP_DT, 1))}
    for _ in range(STEPS):
        state, _diag = advance.advance_timestep(sim, state, STEP_DT,
                                                projection.REGULAR_TIMESTEP)
    out["steps"] = _state_np(gather_state(sim, state))
    return out


def _state_np(st):
    return {k: _np(getattr(st, k)) for k in ("u", "s", "gp", "p")}


def run_case(nranks, name):
    """One case by name, its result in plain numpy and numbers."""
    kind, _, arg = name.partition(":")
    if kind == "halo":
        return case_halo(nranks)
    if kind == "fill":
        return case_fill(nranks)
    if kind == "estdt":
        return case_estdt(nranks)
    if kind == "mg":
        return case_mg(nranks, arg)
    if kind == "nodal":
        return case_nodal(nranks, arg)
    if kind == "steps":
        st, cycles = case_steps(nranks, arg)
        return _state_np(st), cycles
    if kind == "inlet":
        st, cycles, t = case_inlet(nranks)
        return _state_np(st), cycles, t
    if kind == "debug":
        return case_debug(nranks)
    raise ValueError(name)


def run_batch(names):
    """Run every case on this rank of the group; rank 0 returns
    {name: result}, the others None."""
    torch.set_default_dtype(torch.float64)
    nranks = dist.get_world_size()
    out = {name: run_case(nranks, name) for name in names}
    out["_exchanges"] = halo.exchanges.as_dict()
    return out if dist.get_rank() == 0 else None
