"""The port's spans and counters (varden_tpu_torch.profiling), on the CPU
in float64 at 16^3, and on the card (marked ``gpu``) at 32^3.

A span is a torch.profiler range while the profiler runs and the shared
null context otherwise; every name the package passes to ``span`` is in
the one registry, which ``advance.RANGES`` is, and any other name is
refused. Over one step of each benchmark configuration the program's
V-cycle counters read what the benchmark's wrapper
(portbench/trace.Instruments) counts, and the per-step history of host
reads repeats exactly between two identical runs. On the card a step
synchronizes only at the counted read sites:

    python -m pytest tests/test_torch_tracing.py --noconftest -q -m gpu
"""
import os
import re
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import cell as cell_mod
from portbench import harness
from portbench import trace as trace_mod
from varden_tpu_torch import advance, profiling
from varden_tpu_torch.config import VardenConfig
from varden_tpu_torch.driver import Varden

PACKAGE = os.path.dirname(os.path.abspath(profiling.__file__))
CELLS = ["bubble3d.l1-256", "rt3d.l1-256"]


def _varden(name, n=16, device="cpu"):
    """A Varden of the cell's configuration at n^3 cells, initialized from
    the problem's own initial data: (v, state)."""
    kw = cell_mod.resolve(name).settings()
    kw.update(n_cellx=n, n_celly=n, n_cellz=n, verbose=0)
    v = Varden(VardenConfig(**kw), device=device)
    return v, v.initialize()


def _names(prof):
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("on", [True, False], ids=["profiler", "off"])
def test_span_is_a_range_only_under_the_profiler(on):
    if on:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("mg::vcycle"):
                torch.ones(4).sum()
        assert "mg::vcycle" in _names(prof)
    else:
        sp = profiling.span("mg::vcycle")
        assert sp is profiling.NULL
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with sp:
                torch.ones(4).sum()
        assert "mg::vcycle" not in _names(prof)


def test_every_span_name_is_registered():
    assert advance.RANGES is profiling.SPANS
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    used, calls = set(), set()
    for root, _dirs, files in os.walk(PACKAGE):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(root, f)) as fh:
                src = fh.read()
            used |= set(re.findall(r'span\("([^"]+)"\)', src))
            if f != "profiling.py" and "record_function" in src:
                calls.add(f)
    assert used and used <= set(profiling.SPANS), used - set(profiling.SPANS)
    assert set(profiling.SPANS) <= used, set(profiling.SPANS) - used
    assert not calls, f"record_function outside profiling.py: {calls}"


@pytest.mark.parametrize("state", ["off", "summary", "profiler"])
def test_unregistered_span_name_raises(state):
    try:
        if state == "summary":
            profiling.reset()
        if state == "profiler":
            with profile(activities=[ProfilerActivity.CPU]):
                with pytest.raises(KeyError):
                    profiling.span("mg::vcycles")
        else:
            with pytest.raises(KeyError):
                profiling.span("mg::vcycles")
    finally:
        profiling.reset(on=False)


@pytest.mark.parametrize("name", CELLS)
def test_vcycle_counters_equal_the_benchmarks_wrapper(name):
    v, st = _varden(name)
    port = harness.Port()
    inst = trace_mod.Instruments(port, v.cfg.dtype)
    c0 = {k: profiling.counter(k).count
          for k in ("vcycles.mg", "vcycles.nodal")}
    try:
        v.step(st)
    finally:
        inst.remove()
    ours = sum(profiling.counter(k).count - c for k, c in c0.items())
    assert ours > 0
    assert ours == inst.vcycles
    assert profiling.HISTORY[-1]["vcycles.mg"] \
        + profiling.HISTORY[-1]["vcycles.nodal"] == ours


def _reads(entry):
    return {k: c for k, c in entry.items() if k.startswith("host_reads.")}


def _counted():
    return {k: c.count for k, c in profiling.COUNTERS.items()
            if k.startswith("host_reads.")}


@pytest.mark.parametrize("name", CELLS)
def test_host_reads_history_repeats(name):
    steps = 2
    runs = []
    for _ in range(2):
        v, st = _varden(name)
        before = _counted()
        for _ in range(steps):
            st = v.step(st)
        after = _counted()
        hist = [_reads(e) for e in list(profiling.HISTORY)[-steps:]]
        total = sum(after[k] - before.get(k, 0) for k in after)
        assert sum(sum(e.values()) for e in hist) == total
        runs.append(hist)
    assert runs[0] == runs[1]
    # the first step takes initialize's dt; the second reads estdt's
    sites = [{k.split(".", 1)[1] for k in entry} for entry in runs[0]]
    common = {"driver.health", "mg.monitor", "nodal.monitor", "mg.build",
              "nodal.build"}
    assert common <= sites[0] and "estdt" not in sites[0], sites[0]
    assert common | {"estdt"} <= sites[1], sites[1]


def test_history_is_bounded():
    assert profiling.HISTORY.maxlen >= 4096


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync check runs on the card")
    return torch.device("cuda")


class _Quiet:
    """Sync debug mode off inside a counted read."""

    def __enter__(self):
        self.mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self.mode)
        return False


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_step_syncs_only_at_counted_reads(cuda, name, monkeypatch):
    from varden_tpu_torch.ops import _cuda
    _cuda.build_all()
    read, library_read = profiling.read, profiling.library_read

    def quiet_read(t, site):
        with _Quiet():
            return read(t, site)

    def quiet_library_read(site):
        library_read(site)
        return _Quiet()

    monkeypatch.setattr(profiling, "read", quiet_read)
    monkeypatch.setattr(profiling, "library_read", quiet_library_read)
    v, st = _varden(name, n=32, device=cuda)
    st = v.step(st)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            v.step(st)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
             if "synchroniz" in str(w.message)]
    assert not syncs, "\n".join(syncs)
