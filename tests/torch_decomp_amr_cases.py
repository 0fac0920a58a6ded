"""The cases of tests/test_torch_decomp_amr.py and
tests/test_torch_decomp_io.py: each runs on one rank (no process group: the
one-rank reference at the same ``mesh``) or on every rank of a gloo group
started by varden_tpu_torch.parallel.launch, where rank 0 returns what the
test compares. Only torch and numpy are imported here, so that the spawned
ranks start quickly."""
import os
import warnings

import torch
import torch.distributed as dist

from varden_tpu_torch import projection
from varden_tpu_torch.amr import advance_ml
from varden_tpu_torch.amr import solve as amr_solve
from varden_tpu_torch.amr.fill import MLGeom, pad_ml
from varden_tpu_torch.amr.hierarchy import LevelSpec
from varden_tpu_torch.config import VardenConfig
from varden_tpu_torch.driver import Varden, gather_states_ml
from varden_tpu_torch.parallel import halo
from varden_tpu_torch.parallel.mesh import make_patch_decomp
from varden_tpu_torch.state import Sim, State

import torch_decomp_cases as base_cases

WALLS2 = dict(bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15)
# tests/test_sharding.py::test_driver_mesh_mode_two_level
TWO_LEVEL = dict(dim_in=2, prob_type=1, n_cellx=32, n_celly=32, max_levs=2,
                 regrid_int=-1, max_step=2, init_iter=1, grav=-9.8,
                 cflfac=0.9, init_shrink=0.1, dtype="float64", **WALLS2)
# inputs_3d-regt's settings at a 16^3 base (regrid every 2 steps)
REGT = dict(dim_in=3, prob_type=1, n_cellx=16, n_celly=16, n_cellz=16,
            max_levs=2, max_step=3, regrid_int=2, init_iter=1, grav=-9.8,
            visc_coef=1e-3, cflfac=0.5, init_shrink=0.1, dtype="float64",
            bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15, bcz_lo=15,
            bcz_hi=15)
# the RT geometry (periodic x and y, walls in z) at a 16^3 base
RT3 = dict(dim_in=3, prob_type=3, n_cellx=16, n_celly=16, n_cellz=16,
           max_levs=2, max_step=2, regrid_int=1, init_iter=1, grav=-1.0,
           cflfac=0.5, init_shrink=0.1, dtype="float64",
           bcx_lo=-1, bcx_hi=-1, bcy_lo=-1, bcy_hi=-1, bcz_lo=15, bcz_hi=15)
# BASELINE config 5's settings (base + 2 levels, no regrid) at 16^3
CFG5 = dict(dim_in=3, prob_type=1, n_cellx=16, n_celly=16, n_cellz=16,
            max_levs=3, max_step=2, regrid_int=-1, init_iter=0, grav=-9.8,
            visc_coef=1e-3, cflfac=0.5, init_shrink=0.5, dtype="float64",
            bcx_lo=15, bcx_hi=15, bcy_lo=15, bcy_hi=15, bcz_lo=15,
            bcz_hi=15)
RUNS = {"two_level": TWO_LEVEL, "regt": REGT, "rt3": RT3, "cfg5": CFG5}


def _rank():
    return dist.get_rank() if dist.is_initialized() else 0


def _np(t):
    return t.detach().cpu().numpy()


def _states_np(geom, states):
    return [{k: _np(getattr(st, k)) for k in ("u", "s", "gp", "p")}
            for st in gather_states_ml(geom, states)]


def run_steps(kw, mesh, steps=None):
    """A run at ``mesh``, decomposed over the group's ranks (or, on one
    rank, unsharded with the mesh-quantised patches): per step the
    hierarchy's key and the outer and V-cycle counts, and the whole patches
    at the end."""
    cfg = VardenConfig(**dict(kw, mesh=mesh))
    base_cases.count_cycles()
    base_cases.CYCLES.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        v = Varden(cfg, device="cpu")
        states = v.initialize_ml()
        rec = [(v.geom.key(), dict(base_cases.CYCLES))]
        for _ in range(cfg.max_step if steps is None else steps):
            base_cases.CYCLES.clear()
            states = v.step_ml(states)
            d = v.last_diag
            rec.append((v.geom.key(), dict(base_cases.CYCLES),
                        int(d["mac_outer"]), int(d["hg_outer"]),
                        float(v.dt)))
    return {"rec": rec, "states": _states_np(v.geom, states)}


def run_case(nranks, name):
    torch.set_default_dtype(torch.float64)
    kind, _, arg = name.partition(":")
    arg, _, mesh = arg.partition("@")
    if kind == "run":
        arg, _, steps = arg.partition("/")
        return run_steps(RUNS[arg], int(mesh),
                         int(steps) if steps else None)
    if kind == "copy":
        return case_copy(nranks)
    if kind == "ops":
        return case_ops(nranks, arg)
    if kind == "solves":
        return case_solves(nranks, arg)
    if kind == "nodes":
        return case_nodes(nranks, arg)
    raise KeyError(name)


def run_batch(names):
    """Every case of ``names`` on this rank (the spawn target)."""
    return {name: run_case(dist.get_world_size(), name) for name in names}


# ---------------------------------------------------------------------------
# the coarse-fine operators on blocks against the whole patches, sliced:
# bit for bit

GEOMS = {
    # a child cut on both axes and one whose x axis replicates (18 cells
    # do not cut into even blocks of 2 ranks)
    "walls2d": (dict(dim_in=2, prob_type=1, n_cellx=32, n_celly=32,
                     max_levs=2, dtype="float64", **WALLS2),
                [((0, 0), (32, 32)), ((8, 8), (24, 32)),
                 ((44, 40), (18, 16))], [-1, 0, 0], [0, 1, 1]),
    # periodic x and y: a child spanning x (a split periodic patch axis)
    "per3d": (dict(RT3, max_levs=2),
              [((0, 0, 0), (16, 16, 16)), ((0, 8, 8), (32, 16, 16))],
              [-1, 0], [0, 1]),
    # inflow at x lo, outflow at x hi: a child over part of the inlet face
    "inlet3d": (dict(dim_in=3, prob_type=2, n_cellx=16, n_celly=16,
                     n_cellz=16, max_levs=2, dtype="float64",
                     bcx_lo=11, bcx_hi=12, bcy_lo=15, bcy_hi=15, bcz_lo=15,
                     bcz_hi=15,
                     u_bc=((1.0, 0.0), (0.0, 0.0), (0.0, 0.0)),
                     rho_bc=((1.0, 0.0), (0.0, 0.0), (0.0, 0.0))),
                [((0, 0, 0), (16, 16, 16)), ((0, 8, 8), (16, 16, 16))],
                [-1, 0], [0, 1]),
}


def _pair(name, nranks):
    """(whole geometry, decomposed geometry) of GEOMS[name]."""
    kw, specs, parent, depth = GEOMS[name]
    cfg = VardenConfig(**kw)
    sims = []
    for ranks in (0, nranks):
        sim = Sim(cfg, device="cpu")
        sim.ml_ranks = ranks if ranks > 1 else 0
        sims.append(sim)
    lv = [LevelSpec(tuple(lo), tuple(n)) for lo, n in specs]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tuple(MLGeom(s, lv, parent, depth) for s in sims)


def _rand(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g, dtype=torch.float64) + 0.5


def _cut(geom, l, whole, grow=0, extra=None):
    """The rank's block of a whole patch tensor grown by ``grow`` (a padded
    tensor of the whole patch), ``extra[d]`` more entries at the hi end."""
    dm = geom.dm
    dec = geom.decs[l]
    lo = (0,) * dm if dec is None else dec.lo
    extra = extra or (0,) * dm
    idx = (slice(None),) * (whole.ndim - dm) + tuple(
        slice(lo[d], lo[d] + geom.bn(l)[d] + 2 * grow + extra[d])
        for d in range(dm))
    return whole[idx]


def case_copy(nranks):
    """fetch and put against slices of the whole patch: cells (padded and
    across a periodic seam), faces and nodes; and the received elements of
    one fetch against its box less the rank's own part."""
    err = 0.0
    me = _rank()
    for n, off, pm in (((16, 12, 8), (4, 0, 2), (True, False, False)),
                       ((12, 18), (0, 6), (True, True))):
        dm = len(n)
        dec = make_patch_decomp(n, off, pm, nranks, me, 4)
        for kind in ("cell", "node") + tuple(range(dm)):
            ext = halo.ext_of(kind, dec)
            shape = [s + e for s, e in zip(n, ext)]
            g = _rand([2] + shape, 7)
            if kind == "node":
                loc = dec.block(g, nodal=True)
            else:
                loc = base_cases._faces(g, dec, kind) if kind != "cell" \
                    else dec.block(g)

            def box(r, _pm=pm):
                o = dec.of_rank(r)
                return (tuple(l - 3 if p else max(l - 3, 0)
                              for l, p in zip(o.lo, _pm)),
                        tuple(l + b + 2 if p else min(l + b + 2, s)
                              for l, b, p, s in zip(o.lo, o.n, _pm, shape)))
            got = halo.fetch(loc, dec, box, kind=kind, wrap=True)
            lo, hi = box(me)
            ref = g
            for d in range(dm):
                idx = torch.arange(lo[d], hi[d]) % shape[d]
                ref = ref.index_select(1 + d, idx)
            err = max(err, float((got - ref).abs().max()))
            # put: each rank writes 3x its block into a zero patch
            dst = torch.zeros_like(loc)
            halo.put(dst, dec, lambda r: (dec.of_rank(r).lo, tuple(
                l + s for l, s in zip(dec.of_rank(r).lo, loc.shape[1:]))),
                3 * loc, kind=kind)
            err = max(err, float((dst - 3 * loc).abs().max()))
    # padded: one fetch's received elements are its box less its own part
    dec = make_patch_decomp((16, 16), (0, 0), (False, False), nranks, me, 4)
    loc = torch.zeros(1, dec.n[0] + 4, dec.n[1] + 4)
    box = ((3, 5), (11, 13))
    halo.copies.reset()
    halo.fetch(loc, dec, lambda r: box, pad=2)
    own = 1
    for d in range(2):
        own *= max(0, min(box[1][d], dec.lo[d] + dec.n[d])
                   - max(box[0][d], dec.lo[d]))
    want = (box[1][0] - box[0][0]) * (box[1][1] - box[0][1]) - own
    return {"err": float(halo.all_max(torch.tensor(err))),
            "received": halo.copies.elements, "want": want}


def case_ops(nranks, name):
    """max |block operator - the whole patches' operator, sliced| for the
    ghost fills, the MAC growth, the restrictions and the flux sync, and
    the dt estimate."""
    g0, gd = _pair(name, nranks)
    dm, nlev = g0.dm, g0.nlev
    sim = g0.sim
    err = {}

    def note(k, a, b):
        err[k] = max(err.get(k, 0.0), float((a - b).abs().max()))

    def cells(l, nc, seed):
        return _rand((nc,) + g0.specs[l].n, seed + 10 * l)

    def faces(l, seed):
        return tuple(_rand(tuple(s + (1 if t == d else 0)
                                 for t, s in enumerate(g0.specs[l].n)),
                           seed + 10 * l + d) for d in range(dm))

    u = [cells(l, dm, 1) for l in range(nlev)]
    s = [cells(l, sim.nscal, 2) for l in range(nlev)]
    ub = [gd.block(l, x) for l, x in enumerate(u)]
    sb = [gd.block(l, x) for l, x in enumerate(s)]
    for l in range(nlev):
        for comp, arrs, arrb in ((0, [x[0] for x in u], [x[0] for x in ub]),
                                 (dm, [x[0] for x in s], [x[0] for x in sb])):
            for ng in (1, 3):
                note("pad_ml", pad_ml(gd, arrb, comp, l, ng),
                     _cut(gd, l, pad_ml(g0, arrs, comp, l, ng), ng))
        ell = [tuple(sim.ell_bc[0][d]) for d in range(dm)]
        bv = [[0.3, 0.7]] * dm
        note("pad_phi", amr_solve.pad_phi(gd, l, [x[0] for x in ub], ell, bv),
             _cut(gd, l, amr_solve.pad_phi(g0, l, [x[0] for x in u], ell,
                                           bv), 1))
        note("pad_corr", amr_solve.pad_corr(gd, l, ub[l][0], ell),
             _cut(gd, l, amr_solve.pad_corr(g0, l, u[l][0], ell), 1))
    mac = [faces(l, 3) for l in range(nlev)]
    macb = [tuple(_cut(gd, l, m, extra=[int(t == d) for t in range(dm)])
                  for d, m in enumerate(mac[l])) for l in range(nlev)]
    for l in range(nlev):
        n = gd.bn(l)
        for d, (a, b) in enumerate(zip(advance_ml.grow_mac_ml(gd, macb, l, 3),
                                       advance_ml.grow_mac_ml(g0, mac, l, 3))):
            # the faces and their one tangential ghost layer (the rest of
            # the cell-aligned tensor is never read)
            idx = tuple(slice(3, 4 + n[t]) if t == d else slice(2, 4 + n[t])
                        for t in range(dm))
            note("grow_mac_ml", a[idx], _cut(gd, l, b, 3)[idx])
    for l, (a, b) in enumerate(zip(advance_ml.edge_restrict_mac(gd, macb),
                                   advance_ml.edge_restrict_mac(g0, mac))):
        for d in range(dm):
            note("edge_restrict_mac", a[d],
                 _cut(gd, l, b[d], extra=[int(t == d) for t in range(dm)]))
    for l, (a, b) in enumerate(zip(advance_ml.restrict_and_sync(gd, ub),
                                   advance_ml.restrict_and_sync(g0, u))):
        note("restrict_and_sync", a, _cut(gd, l, b))
    flux = [tuple(torch.stack([f, 2 * f]) for f in m) for m in mac]
    fluxb = [tuple(torch.stack([f, 2 * f]) for f in m) for m in macb]
    for cons in ([True, True], [True, False]):
        for l, (a, b) in enumerate(zip(advance_ml.flux_sync(gd, fluxb, cons),
                                       advance_ml.flux_sync(g0, flux, cons))):
            for d in range(dm):
                note("flux_sync", a[d], _cut(
                    gd, l, b[d], extra=[int(t == d) for t in range(dm)]))
    gp = [0.1 * x for x in u]
    st0 = [State(u=u[l], s=s[l], gp=gp[l], p=None) for l in range(nlev)]
    std = [State(u=ub[l], s=sb[l], gp=0.1 * ub[l], p=None)
           for l in range(nlev)]
    err["ml_estdt"] = abs(advance_ml.ml_estdt(gd, std, 1e-3)
                          - advance_ml.ml_estdt(g0, st0, 1e-3))
    out = {k: float(halo.all_max(torch.tensor(v))) for k, v in err.items()}
    out["rep"] = [bool(d.rep) for d in gd.decs]
    return out


def case_solves(nranks, name):
    """The composite MAC (face beta) and nodal solves on blocks against
    the whole patches': max |difference| over each field's size, and the
    outer and V-cycle counts of both."""
    g0, gd = _pair(name, nranks)
    dm, nlev = g0.dm, g0.nlev
    sim = g0.sim
    out = {}
    base_cases.count_cycles()
    for key, g in (("one", g0), ("dec", gd)):
        rho = [_rand((1,) + g0.specs[l].n, 20 + l) for l in range(nlev)]
        rhs = [_rand(g0.specs[l].n, 30 + l) - 1.0 for l in range(nlev)]
        vel = [_rand((dm,) + g0.specs[l].n, 40 + l) - 1.0
               for l in range(nlev)]
        if g is gd:
            rho = [gd.block(l, x) for l, x in enumerate(rho)]
            rhs = [gd.block(l, x) for l, x in enumerate(rhs)]
            vel = [gd.block(l, x) for l, x in enumerate(vel)]
        beta = []
        for l in range(nlev):
            pad = pad_ml(g, [r[0] for r in rho], sim.scal_comp(0), l, 1)
            beta.append(tuple(projection._face_diff(
                pad, d, dm, lambda h, lo: 2.0 / (h + lo))
                for d in range(dm)))
        aco = [torch.zeros(g.bn(l)) for l in range(nlev)]
        base_cases.CYCLES.clear()
        phis, (_rn, outer, _r) = amr_solve.composite_cc_solve(
            g, sim.press_comp, rhs, aco, beta, 0.0, rel_eps=1e-10,
            return_info=True)
        cyc_cc = dict(base_cases.CYCLES)
        base_cases.CYCLES.clear()
        sig = [1.0 / r[0] for r in rho]
        base_inflow = projection._inflow_pad(sim)
        inflow = [base_inflow] + [
            (lambda c, d, side, _l=l: base_inflow(c, d, side)
             if g.side_kind(_l, d, side) == "phys" else 0.0)
            for l in range(1, nlev)]
        nphis, (_rn, nouter, _r) = amr_solve.composite_nodal_solve(
            g, sig, vel, inflow_pad_l=inflow, rel_eps=1e-10,
            return_info=True)
        cyc_nd = dict(base_cases.CYCLES)
        out[key] = {
            "cc": [_np(g.gather(l, p)) for l, p in enumerate(phis)],
            "nd": [_np(g.gather(l, p, True)) for l, p in enumerate(nphis)],
            "counts": (outer, nouter, cyc_cc, cyc_nd)}
    out["rep"] = [bool(d.rep) for d in gd.decs]
    return out


# ---------------------------------------------------------------------------
# plotfiles, checkpoints and restarts of decomposed runs

IO_RUNS = {
    "sl": dict(dim_in=2, prob_type=1, n_cellx=16, n_celly=16, grav=-9.8,
               dtype="float64", visc_coef=1e-3, cflfac=0.9, init_shrink=0.1,
               init_iter=1, max_levs=1, max_step=4, chk_int=2, plot_int=2,
               verbose=0, **WALLS2),
}
IO_RUNS["ml"] = dict(IO_RUNS["sl"], n_cellx=32, n_celly=32, max_levs=2,
                     regrid_int=2)


class _WriteSpy:
    """Records the files and directories a rank creates (os.makedirs and
    open for writing)."""

    def __init__(self):
        import builtins
        self.seen = []
        self._open, self._mk = builtins.open, os.makedirs

    def __enter__(self):
        import builtins

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


def run_io(name, mesh, outdir, restart=-1, copy_from=None):
    """IO_RUNS[name] at ``mesh`` writing into ``outdir`` (restarted from
    chk<restart> copied from ``copy_from`` by rank 0); returns rank 0's
    whole final patches and what every rank other than 0 wrote."""
    import shutil
    cfg = VardenConfig(**dict(IO_RUNS[name], mesh=mesh, restart=restart,
                              plot_base_name=os.path.join(outdir, "plt"),
                              check_base_name=os.path.join(outdir, "chk")))
    if _rank() == 0:
        os.makedirs(outdir, exist_ok=True)
        if restart >= 0:
            chk = f"chk{restart:05d}"
            shutil.copytree(os.path.join(copy_from, chk),
                            os.path.join(outdir, chk))
    if dist.is_initialized():
        dist.barrier()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        v = Varden(cfg, device="cpu")
        with _WriteSpy() as spy:
            st = v.run()
    whole = v.gather(st)
    whole = whole if isinstance(whole, list) else [whole]
    seen = [spy.seen]
    if dist.is_initialized():
        seen = [None] * dist.get_world_size()
        dist.all_gather_object(seen, spy.seen)
    return {"states": [{k: _np(getattr(s, k)) for k in ("u", "s", "gp", "p")}
                       for s in whole],
            "istep": v.istep, "time": v.time,
            "key": v.geom.key() if v.ml else None,
            "others_wrote": [w for r, w in enumerate(seen) if r and w]}


def run_io_batch(jobs):
    """The spawn target of the I/O cases: each job (name, outdir, restart,
    copy_from) in turn on the group's ranks at mesh = its size."""
    return [run_io(name, dist.get_world_size(), outdir, restart, src)
            for name, outdir, restart, src in jobs]


def case_nodes(nranks, name):
    """The nodal coarse-fine operators on blocks against the whole
    patches', sliced: the interface values, the prolongation, the fold of
    a child's residual, the slaving of covered parent nodes, the masks and
    the unmasked apply."""
    from varden_tpu_torch.solvers import nodal
    g0, gd = _pair(name, nranks)
    dm, nlev = g0.dm, g0.nlev
    err = {}

    def nodes(g, l, seed):
        whole = _rand(nodal.node_shape(g0.specs[l].n, g0.pmask_level(l)),
                      seed + l)
        return whole if g is g0 else gd.block(l, whole, True)

    def note(k, a, b):
        err[k] = max(err.get(k, 0.0), float((a - b).abs().max()))

    for c in range(1, nlev):
        p = g0.parent[c]
        pa, pb = nodes(g0, p, 5), nodes(gd, p, 5)
        ca, cb = nodes(g0, c, 6), nodes(gd, c, 6)
        note("prolong", amr_solve._prolonged(gd, c, pb),
             gd.block(c, amr_solve._prolonged(g0, c, pa), True))
        note("interface",
             amr_solve._set_interfaces_level(gd, c, cb.clone(), pb),
             gd.block(c, amr_solve._set_interfaces_level(g0, c, ca.clone(),
                                                         pa), True))
        note("fold", amr_solve.fold_nodes(gd, c, pb.clone(), cb),
             gd.block(p, amr_solve.fold_nodes(g0, c, pa.clone(), ca), True))
        note("slave", amr_solve.slave_nodes(gd, c, pb.clone(), cb),
             gd.block(p, amr_solve.slave_nodes(g0, c, pa.clone(), ca), True))
        note("mask", amr_solve.fine_nodal_mask(gd, c),
             gd.block(c, amr_solve.fine_nodal_mask(g0, c), True))
        sig = _rand(g0.specs[c].n, 9)
        l0 = nodal.NodalLevel(tuple(g0.bn(c)), tuple(g0.dx(c)),
                              tuple(g0.bpmask(c)), sig,
                              torch.zeros(()), None)
        ld = l0 if gd.sdec(c) is None else nodal.make_dlevel(
            gd.bn(c), gd.dx(c), gd.bpmask(c), gd.block(c, sig), None,
            gd.sdec(c))
        note("apply", nodal.nd_apply_raw(ld, cb),
             gd.block(c, nodal.nd_apply_raw(l0, ca), True))
    return {k: float(halo.all_max(torch.tensor(v))) for k, v in err.items()}
