"""Run the port's CUDA kernels on the CPU, to rehearse a new kernel before
its first run on the card.

Each csrc/<name>.cu (with the headers it includes) is rewritten into plain
C++ (the launches into loops over blocks, the CUDA qualifiers dropped,
dynamic shared memory into one buffer a block, filled with NaN bytes so
that a read of a value never written shows), compiled by g++ against the
stub cuda_runtime.h beside this file (one std::thread per CUDA thread,
std::barrier for __syncthreads, blocks one after another), and loaded in
place of the nvcc-built library; the wrappers' launch functions then run
it on CPU tensors:

    import sys; sys.path.insert(0, "tools/cuda_emu")
    import emulate
    emulate.install()          # builds on first use, under _build/emu/
    out = ck._gsrb_const_launch(phi, rhs, inv, coef, ell, bv, aco,
                                "smooth", 2, None, (2, 2, 2))

and the result is compared with the plain version. ``EMU_ASAN=1`` builds
with AddressSanitizer (run Python with ``LD_PRELOAD`` of g++'s
libasan.so and ``ASAN_OPTIONS=detect_leaks=0``). Slow: seconds for a few
blocks at 16^3. Warp shuffles are not emulated: a block-wide max becomes
one atomic max a thread. What it cannot show: timing, register and shared
memory limits, and whatever nvcc would refuse.
"""
import ctypes
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from varden_tpu_torch.ops import _cuda  # noqa: E402

OUT = os.path.join(_cuda.BUILD, "emu")
_libs = {}


def _split_top(s):
    out, depth, cur = [], 0, ""
    for ch in s:
        depth += (ch in "([{") - (ch in ")]}")
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    return out + [cur]


def _launch(m):
    kern, cfg, args = m.group(1), m.group(2), m.group(3)
    parts = [p.strip() for p in _split_top(cfg)]
    smem = parts[2] if len(parts) > 2 else "0"
    return (f"emu_launch(emu_dim({parts[0]}), emu_dim({parts[1]}), {smem}, "
            f"[=] {{ {kern}({args}); }});")


def translate(src):
    """CUDA source text -> C++ for the stub runtime."""
    src = re.sub(r"([\w:<>, ]+?)<<<(.*?)>>>\((.*?)\);", _launch, src,
                 flags=re.S)
    src = re.sub(r"extern __shared__ __align__\(16\) unsigned char "
                 r"(\w+)\[\];", r"unsigned char* \1 = g_dyn_smem;", src)
    src = src.replace("__shared__", "static")
    src = re.sub(r"__launch_bounds__\([^)]*\)", "", src)
    for k in ("__global__", "__device__", "__host__", "__forceinline__"):
        src = src.replace(k, "")
    return re.sub(r"block_max_to<T>\((\w+), (\w+)\);",
                  r"atomic_max_nonneg<T>(\1, \2);", src)


def build(name):
    """Compile csrc/<name>.cu for the CPU; returns the library's path."""
    gen = os.path.join(OUT, name)
    os.makedirs(gen, exist_ok=True)
    for fn in os.listdir(_cuda.CSRC):
        if fn.endswith(".cuh") or fn == name + ".cu":
            with open(os.path.join(_cuda.CSRC, fn)) as f:
                text = translate(f.read())
            with open(os.path.join(gen, fn), "w") as f:
                f.write(text)
    so = os.path.join(OUT, f"lib{name}.so")
    flags = ["-O0", "-g", "-fsanitize=address"] if os.environ.get(
        "EMU_ASAN") else ["-O1"]
    subprocess.run(["g++", "-std=c++20", *flags, "-shared", "-fPIC",
                    "-pthread", "-I", HERE, "-x", "c++",
                    os.path.join(gen, name + ".cu"), "-o", so], check=True)
    return so


def _lib(name):
    if name not in _libs:
        L = ctypes.CDLL(build(name))
        L.vt_error_string.argtypes = [ctypes.c_int]
        L.vt_error_string.restype = ctypes.c_char_p
        _libs[name] = L
    return _libs[name]


def _call(name, entry, ptrs, iv, dv, like):
    suffix = {torch.float32: "f32", torch.float64: "f64"}[like.dtype]
    fn = getattr(_lib(name), f"{entry}_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    P = (ctypes.c_void_p * len(ptrs))(
        *[None if t is None else t.data_ptr() for t in ptrs])
    I = (ctypes.c_longlong * len(iv))(*[int(v) for v in iv])
    D = (ctypes.c_double * max(len(dv), 1))(*[float(v) for v in dv])
    err = fn(P, I, D, None)
    if err:
        raise RuntimeError(f"{entry}: emulated launch failed ({err})")


def _check(t, name, shape=None, dtype=None, device=None):
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def install():
    """Route the wrappers' launches (_cuda.call) to the emulated libraries
    and accept CPU tensors in their checks (_cuda.check)."""
    _cuda.call = _call
    _cuda.check = _check
