"""The hand-written CUDA kernel of the cell update (counterpart of
varden_tpu.ops.pallas_kernels.update_3d).

  update_3d   csrc/update.cu   = basic.update_plain in 3-D

On a CPU tensor the wrapper runs its plain PyTorch version; on a CUDA tensor
it launches the kernel or raises. ``update_3d.launches`` counts the CUDA
launches the wrapper made.
"""
from __future__ import annotations

import torch

from . import _cuda
from .basic import update_plain


def update_3d_plain(sold, umac, sedge, flux, force, dt, dx, is_conservative):
    """The plain PyTorch version of update_3d."""
    return update_plain(sold, umac, sedge, flux, force, dt, dx,
                        is_conservative)


def update_3d(sold, umac, sedge, flux, force, dt, dx, is_conservative):
    """snew = sold - dt*(u·grad s | div flux) + dt*force per component,
    conservative or convective per component. sold/force: (nc, n0, n1, n2);
    umac[d]: faces (n_d + 1 along d); sedge[d]/flux[d]: (nc, faces). force
    may be None (zero); sedge (flux) may be None when every (no) component
    is conservative."""
    if sold.device.type == "cpu":
        return update_3d_plain(sold, umac, sedge, flux, force, dt, dx,
                               is_conservative)
    if sold.ndim != 4:
        raise ValueError(f"update_3d: sold must be (nc, n0, n1, n2), got "
                         f"{tuple(sold.shape)}")
    nc, n = sold.shape[0], tuple(sold.shape[1:])
    if not 1 <= nc <= 31:
        raise ValueError(f"update_3d: {nc} components (1-31)")
    _cuda.check(sold, "sold")
    kw = dict(dtype=sold.dtype, device=sold.device)
    faces = [tuple(n[t] + (1 if t == d else 0) for t in range(3))
             for d in range(3)]
    cons = [bool(is_conservative[c]) for c in range(nc)]
    if force is not None:
        _cuda.check(force, "force", (nc,) + n, **kw)
    for d in range(3):
        _cuda.check(umac[d], f"umac[{d}]", faces[d], **kw)
        if not all(cons):
            _cuda.check(sedge[d], f"sedge[{d}]", (nc,) + faces[d], **kw)
        if any(cons):
            _cuda.check(flux[d], f"flux[{d}]", (nc,) + faces[d], **kw)
    snew = torch.empty((nc,) + n, **kw)
    edges = list(sedge) if not all(cons) else [None] * 3
    fluxes = list(flux) if any(cons) else [None] * 3
    _cuda.call("update", "update3d",
               [sold, force, *umac, *edges, *fluxes, snew],
               [*n, nc, sum(1 << c for c in range(nc) if cons[c])],
               [float(dt), *map(float, dx)], sold)
    update_3d.launches += 1
    return snew


update_3d.launches = 0
