"""Spawn a group of ranks on this host and collect what each returns.

``spawn(fn, nranks, *args)`` starts ``nranks`` processes (the ``spawn``
start method, so ``fn`` must be a module-level function) of one CPU
thread each, joins them into one gloo group over
``tcp://127.0.0.1:<free port>`` and calls ``fn(*args)`` on each. It
returns the list of their results by rank, and raises with the failing
rank's traceback if any rank raised, or if the group has not finished
within ``timeout`` seconds (the processes are then killed). Gloo ranks
may share one card: the tests run them on the CPU, chip_smoke.py phase 16
on the card.
"""
from __future__ import annotations

import queue
import socket
import time
import traceback


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, nranks, port, fn, args, out):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=nranks, rank=rank)
        try:
            out.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def spawn(fn, nranks: int, *args, timeout: float = 180.0):
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, nranks, port, fn, args, out))
             for r in range(nranks)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < nranks:
            left = deadline - time.monotonic()
            try:
                r, ok, val = out.get(timeout=min(max(left, 0.1), 1.0))
            except queue.Empty:
                if left <= 0 or not any(p.is_alive() for p in procs):
                    break
                continue
            (results if ok else errors)[r] = val
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0)
                   if not errors else 5.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
    if errors:
        r = min(errors)
        raise RuntimeError(f"rank {r} of {nranks} failed:\n{errors[r]}")
    if len(results) < nranks:
        missing = sorted(set(range(nranks)) - set(results))
        raise RuntimeError(f"ranks {missing} of {nranks} returned nothing "
                           f"within {timeout:.0f} s (exit codes "
                           f"{[p.exitcode for p in procs]})")
    return [results[r] for r in range(nranks)]

