"""Runtime configuration for varden_tpu_torch.

A self-contained copy of varden_tpu.config (the port imports nothing from the
JAX package). Re-design of the reference's probin system: the ~60 runtime
parameters declared in the reference's ``src/_parameters`` (defaults mirrored
here 1:1) with the namelist parser of ``src/probin.template:72-126`` replaced
by a dataclass + ``&PROBIN`` namelist reader, so the reference's unchanged
``inputs_*`` files drive this framework too.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Tuple

import torch

# Physical BC codes, matching the reference inputs-file integers
# (src/initialize.f90:385-411): -1 periodic, 11 INLET, 12 OUTLET,
# 13 SYMMETRY, 14 SLIP_WALL, 15 NO_SLIP_WALL.
PERIODIC = -1
INTERIOR = 0
INLET = 11
OUTLET = 12
SYMMETRY = 13
SLIP_WALL = 14
NO_SLIP_WALL = 15


@dataclasses.dataclass(frozen=True)
class VardenConfig:
    """All runtime parameters. Defaults follow reference src/_parameters:9-98."""

    dim_in: int = 2
    nscal: int = 2

    prob_type: int = 1

    grav: float = 0.0
    boussinesq: int = 0

    max_step: int = 1
    stop_time: float = -1.0

    ref_ratio: int = 2
    ng_cell: int = 3
    ng_grow: int = 1

    max_levs: int = 1

    max_grid_size: int = 256

    stencil_order: int = 2

    init_iter: int = 4
    plot_int: int = 0
    chk_int: int = 0
    regrid_int: int = -1
    amr_buf_width: int = -1

    cluster_min_eff: float = 0.9
    cluster_min_width: int = 4
    cluster_blocking_factor: int = 4

    prob_lo_x: float = 0.0
    prob_lo_y: float = 0.0
    prob_lo_z: float = 0.0
    prob_hi_x: float = 1.0
    prob_hi_y: float = 1.0
    prob_hi_z: float = 1.0

    use_hypre: int = 0  # accepted for input compatibility; native MG is the only path

    verbose: int = 0
    mg_verbose: int = 0
    cg_verbose: int = 0

    mg_bottom_solver: int = -1
    hg_bottom_solver: int = -1
    max_mg_bottom_nlevels: int = 1000

    init_shrink: float = 1.0
    fixed_dt: float = -1.0

    do_initial_projection: int = 1

    fixed_grids: str = ""
    grids_file_name: str = ""
    restart: int = -1

    bcx_lo: int = 14
    bcy_lo: int = 14
    bcz_lo: int = 14
    bcx_hi: int = 14
    bcy_hi: int = 14
    bcz_hi: int = 14

    diffusion_type: int = 1  # 1 = Crank-Nicolson, 2 = backward Euler

    max_dt_growth: float = 1.1

    slope_order: int = 4

    use_godunov_debug: bool = False
    use_minion: bool = False

    plot_base_name: str = "plt"
    check_base_name: str = "chk"

    visc_coef: float = 0.0
    diff_coef: float = 0.0

    cflfac: float = 0.8

    n_cellx: int = 32
    n_celly: int = 32
    n_cellz: int = 32

    job_name: str = ""

    # Inflow boundary values (reference probin.template:21-23); indexed
    # [direction][side] when parsed from e.g. "u_bc(1,1) = 1.0".
    u_bc: Tuple[Tuple[float, float], ...] = ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0))
    v_bc: Tuple[Tuple[float, float], ...] = ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0))
    w_bc: Tuple[Tuple[float, float], ...] = ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0))
    rho_bc: Tuple[Tuple[float, float], ...] = ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0))
    trac_bc: Tuple[Tuple[float, float], ...] = ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0))

    # --- extensions (not in the reference) ------------------------------------
    # Compute dtype for fields. float64 matches the reference's dp_t;
    # float32 is the fast path on the card.
    dtype: str = "float64"

    # Shard the run over this many devices (0 = single device). Kept for
    # inputs-file parity; the port runs single-device only so far.
    mesh: int = 0

    # Regrid hysteresis of the AMR path (kept for inputs-file parity; the
    # port is single-level so far).
    regrid_slack: int = 8
    regrid_waste: float = 2.5

    # Guard under-converged projection exits: warn when a MAC/HG solve
    # returns with residual > solver_guard x its effective tolerance
    # (0 disables; negative raises instead of warning). The reference's
    # solvers abort outright on non-convergence (bl_error in mg_tower).
    solver_guard: float = 100.0

    # Coarsen plot output by 2x before writing (the reference's
    # coarsen_plot_data branch, varden.f90:521-588 — a compile-time flag
    # there, implemented for single-level runs only).
    coarsen_plot_data: int = 0

    # ------------------------------------------------------------------
    @property
    def dm(self) -> int:
        return self.dim_in

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "float64": torch.float64}[self.dtype]

    @property
    def n_cell(self) -> Tuple[int, ...]:
        return (self.n_cellx, self.n_celly, self.n_cellz)[: self.dm]

    @property
    def prob_lo(self) -> Tuple[float, ...]:
        return (self.prob_lo_x, self.prob_lo_y, self.prob_lo_z)[: self.dm]

    @property
    def prob_hi(self) -> Tuple[float, ...]:
        return (self.prob_hi_x, self.prob_hi_y, self.prob_hi_z)[: self.dm]

    @property
    def phys_bc(self) -> Tuple[Tuple[int, int], ...]:
        """[direction][side] physical BC codes (reference initialize.f90:368-417)."""
        return (
            (self.bcx_lo, self.bcx_hi),
            (self.bcy_lo, self.bcy_hi),
            (self.bcz_lo, self.bcz_hi),
        )[: self.dm]

    @property
    def pmask(self) -> Tuple[bool, ...]:
        return tuple(b[0] == PERIODIC for b in self.phys_bc)

    @property
    def dx(self) -> Tuple[float, ...]:
        """Level-1 cell sizes (reference initialize.f90:419-440)."""
        return tuple(
            (hi - lo) / n for lo, hi, n in zip(self.prob_lo, self.prob_hi, self.n_cell)
        )

    @property
    def ext_force(self) -> Tuple[float, ...]:
        """Constant external velocity forcing: gravity in the last dimension
        (reference varden.f90 make_temps sets ext_vel_force(dm) = grav)."""
        f = [0.0] * self.dm
        f[-1] = self.grav
        return tuple(f)

    def validate(self) -> "VardenConfig":
        if self.dim_in not in (2, 3):
            raise ValueError("dim_in must be 2 or 3")
        if self.nscal < 1:
            raise ValueError("nscal must be at least 1")
        if self.ref_ratio != 2:
            raise ValueError("only ref_ratio=2 hierarchies supported")
        for d, (lo, hi) in enumerate(self.phys_bc):
            if (lo == PERIODIC) != (hi == PERIODIC):
                raise ValueError(f"periodicity must match on both sides of dim {d}")
        # bottom-solver selectors (FBoxLib codes: 0 smoothing, 1/3 BiCGStab,
        # 2 CG; -1/4 the dense direct solve, the only one ported so far)
        import warnings
        from .solvers.mg import BOTTOM_METHODS
        if self.mg_bottom_solver not in BOTTOM_METHODS:
            warnings.warn("unknown mg_bottom_solver=%d; using the dense "
                          "direct bottom solve" % self.mg_bottom_solver)
        if self.hg_bottom_solver not in BOTTOM_METHODS:
            warnings.warn("unknown hg_bottom_solver=%d; using the dense "
                          "direct bottom solve" % self.hg_bottom_solver)
        if self.cg_verbose > 0:
            warnings.warn("cg_verbose has no effect: the only bottom "
                          "solver is the dense direct solve")
        return self


_BOOL = {".true.": True, ".false.": False, "t": True, "f": False,
         "true": True, "false": False}

_IDX_RE = re.compile(r"^(\w+)\((\d+),(\d+)\)$")


def _parse_value(field_type, raw: str):
    raw = raw.strip().rstrip(",").strip()
    if field_type is bool or raw.lower() in _BOOL:
        return _BOOL[raw.lower()]
    if raw.startswith(('"', "'")):
        return raw.strip("\"'")
    # Fortran double-precision literals: 1.d0, 2.5e-3, etc.
    norm = raw.lower().replace("d", "e")
    try:
        if field_type is int:
            return int(float(norm))
        return float(norm)
    except ValueError:
        return raw


def parse_namelist(text: str) -> dict:
    """Parse a Fortran ``&PROBIN ... /`` namelist into a dict.

    Handles ``key = value``, comments (``!`` and ``#``), Fortran literals,
    and 2-index array entries like ``u_bc(1,1) = 1.0``.
    """
    out: dict = {}
    in_group = False
    for line in text.splitlines():
        line = line.split("!")[0].split("#")[0].strip()
        if not line:
            continue
        if line.startswith("&"):
            in_group = True
            continue
        if line in ("/", "&end", "$end"):
            in_group = False
            continue
        if not in_group or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key = key.strip().lower()
        m = _IDX_RE.match(key)
        if m:
            name, i, j = m.group(1), int(m.group(2)), int(m.group(3))
            arr = out.setdefault(name, {})
            arr[(i - 1, j - 1)] = _parse_value(float, val)
        else:
            out[key] = val.strip()
    return out


def load_config(path_or_text: str, is_text: bool = False, **overrides) -> VardenConfig:
    """Build a VardenConfig from a reference-format inputs file.

    ``overrides`` apply after the file, mirroring the reference's
    ``--key value`` CLI override mechanism (probin.template:107-126).
    """
    if is_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    raw = parse_namelist(text)

    fields = {f.name: f for f in dataclasses.fields(VardenConfig)}
    kwargs = {}
    for key, val in raw.items():
        if key not in fields:
            continue  # unknown keys ignored (problem-local params)
        fld = fields[key]
        if isinstance(val, dict):  # indexed array like u_bc(1,1)
            base = [list(row) for row in getattr(VardenConfig, key)]
            for (i, j), v in val.items():
                base[i][j] = v
            kwargs[key] = tuple(tuple(row) for row in base)
        else:
            kwargs[key] = _parse_value(fld.type if fld.type in (int, float, bool) else
                                       {"int": int, "float": float, "bool": bool,
                                        "str": str}.get(str(fld.type), str), val)
    kwargs.update(overrides)
    return VardenConfig(**kwargs).validate()
