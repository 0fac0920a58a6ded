"""Build, load and call the CUDA kernels of varden_tpu_torch/csrc.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds) and
bound with ctypes. Libraries are built at first use into ``_build/`` next to
the package, keyed by a hash of the sources and flags; ``build_all`` starts
one ``nvcc`` per source at once. Nothing here runs at import time.

Every entry point has the signature
    int name_<f32|f64>(void** ptrs, const long long* iv, const double* dv,
                       void* stream)
and returns the cudaError_t of the first launch that failed (see
csrc/common.cuh).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
SOURCES = ("velpred", "mkflux_update", "gsrb_var", "gsrb_const", "nodal",
           "velpred2d", "mkflux2d", "gsrb2d", "update", "mkflux",
           "gsrb_padded")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC",
         # no fused multiply-add contraction: the kernels then round like
         # the plain PyTorch versions they are checked against
         "-fmad=false")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or install the CUDA toolkit)")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == name + ".cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless an up-to-date library exists."""
    out = _lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Build every library at once (one nvcc each); returns seconds."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        for fut in [ex.submit(build, n) for n in names]:
            fut.result()
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            L = ctypes.CDLL(build(name))
            L.vt_error_string.argtypes = [ctypes.c_int]
            L.vt_error_string.restype = ctypes.c_char_p
            _libs[name] = L
        return _libs[name]


def call(name: str, entry: str, ptrs, iv, dv, like: torch.Tensor) -> None:
    """Launch ``entry``_<f32|f64> of library ``name`` on the current stream
    of ``like``'s device; raise on a launch error. ``ptrs`` holds tensors
    (or None for an absent input); every tensor must outlive the call's
    queueing, which the caller guarantees by holding it."""
    L = lib(name)
    suffix = {torch.float32: "f32", torch.float64: "f64"}[like.dtype]
    fn = getattr(L, f"{entry}_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    P = (ctypes.c_void_p * len(ptrs))(
        *[None if t is None else t.data_ptr() for t in ptrs])
    I = (ctypes.c_longlong * len(iv))(*[int(v) for v in iv])
    D = (ctypes.c_double * max(len(dv), 1))(*[float(v) for v in dv])
    stream = torch.cuda.current_stream(like.device).cuda_stream
    err = fn(P, I, D, ctypes.c_void_p(stream))
    if err != 0:
        msg = L.vt_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA launch failed ({err}: {msg})")


def check(t: torch.Tensor, name: str, shape=None, dtype=None, device=None):
    """Wrapper-side validation of one kernel operand."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: dtype {t.dtype} not supported")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
