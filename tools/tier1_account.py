"""Per-test account of JAX compile work in a pytest run (a pytest plugin).

Load it with ``-p tier1_account`` and ``tools`` on ``PYTHONPATH``; it is
not collected as a test. In each process (every xdist worker, or the one
pytest process) it listens to ``jax.monitoring`` and, for each test
(setup, call and teardown, so a module fixture's work lands on the first
test that uses it), appends one JSON line to the file named by
``TIER1_ACCOUNT``:

- ``nodeid``, ``file``, ``worker``, ``start``, ``end``, ``wall`` (s);
- ``trace_s``, ``lower_s``, ``backend_s``: the seconds of
  ``/jax/core/compile/jaxpr_trace_duration``,
  ``jaxpr_to_mlir_module_duration`` and ``backend_compile_duration``;
- ``hits``, ``misses``: the persistent cache's ``cache_hits`` and
  ``cache_misses``; ``saved_s``: ``compile_time_saved_sec``;
- ``compiles``: one ``[key, backend s, lower s, hit]`` per backend
  compile. The key is the persistent cache's key of the module (its
  name and a digest of its text and options: equal keys are the same
  computation) where the cache is on; otherwise the jitted module's name
  and a digest of its argument shapes and dtypes (from
  ``jax_log_compiles``' "Compiling ... with global shapes and types"
  record). ``sig`` maps a key to a short readable form of those shapes.

``trace_s`` counts only the outermost traces: a jit traced inside
another's trace is part of the outer one's seconds.

Work done while a module is imported lands on a ``<collect>`` line of the
worker, and each worker ends with a ``session`` line (its start and end).

    TIER1_ACCOUNT=/tmp/acct.jsonl PYTHONPATH=tools python -m pytest \\
        tests/ -p tier1_account -n 6 --dist loadfile ...
    python tools/tier1_account.py --summary /tmp/acct.jsonl [--top 25]

The summary prints seconds per file and per worker (with each worker's
idle tail before the last worker ends), compile seconds per file, and
every compile key that was compiled more than once, with the tests and
files that compiled it and its total seconds: the repeated work.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import logging
import os
import re
import sys
import time

import pytest

ENV = "TIER1_ACCOUNT"
TRACE = "/jax/core/compile/jaxpr_trace_duration"
LOWER = "/jax/core/compile/jaxpr_to_mlir_module_duration"
BACKEND = "/jax/core/compile/backend_compile_duration"
HITS = "/jax/compilation_cache/cache_hits"
MISSES = "/jax/compilation_cache/cache_misses"
SAVED = "/jax/compilation_cache/compile_time_saved_sec"
COMPILING = re.compile(r"^Compiling (\S+) with global shapes and types ")
CACHE_KEY = re.compile(r"^(Persistent compilation cache hit|"
                       r"PERSISTENT COMPILATION CACHE MISS) for ")
# jax_log_compiles raises these loggers' compile records to WARNING (the
# cache's misses stay at DEBUG); they are read here and kept out of
# pytest's captured logs
READ = {"jax._src.interpreters.pxla": logging.WARNING,
        "jax._src.compiler": logging.DEBUG}
QUIET = ("jax._src.dispatch", "jax._src.pjit")


def _sig(avals) -> str:
    """A short form of a list of avals: 'float64[16,16] x3, int32[]'."""
    counts = collections.Counter(str(a).replace("ShapedArray(", "")
                                 .rstrip(")") for a in avals)
    return ", ".join(s if n == 1 else f"{s} x{n}" for s, n in counts.items())


class _Account(logging.Handler):
    def __init__(self, path: str):
        super().__init__(logging.DEBUG)
        self.path = path
        self.worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        self.sigs: dict[str, str] = {}
        self.key: str | None = None
        self.sig: str | None = None
        self.depth = 0
        self.t0 = time.time()
        self._reset()

    def _reset(self):
        self.start = time.time()
        self.acc = dict(trace_s=0.0, lower_s=0.0, backend_s=0.0, hits=0,
                        misses=0, saved_s=0.0)
        self.compiles: list[list] = []
        self.lower_pending = 0.0
        self.hit_pending = False
        self.outcome = "passed"

    # logging.Handler: the "Compiling <module> with global shapes" record,
    # then (persistent cache on) the cache's hit or miss with its key
    def emit(self, record):
        msg = str(record.msg)
        if COMPILING.match(msg) and record.args:
            name, avals = record.args[0], record.args[1]
            full = f"{name} {[str(a) for a in avals]}"
            self.key = f"{name}#{hashlib.sha1(full.encode()).hexdigest()[:10]}"
            self.sig = _sig(avals)
        elif CACHE_KEY.match(msg) and len(record.args or ()) == 2:
            self.key = str(record.args[1])

    def on_scalar(self, event, value, **kw):
        if event == TRACE:  # a trace starts
            self.depth += 1

    def on_duration(self, event, secs, **kw):
        if event == TRACE:
            self.depth = max(0, self.depth - 1)
            if self.depth == 0:
                self.acc["trace_s"] += secs
        elif event == LOWER:
            self.acc["lower_s"] += secs
            self.lower_pending += secs
        elif event == BACKEND:
            self.acc["backend_s"] += secs
            key = self.key or f"{kw.get('fun_name', '?')}#?"
            if self.sig is not None:
                self.sigs.setdefault(key, self.sig)
            self.compiles.append([key, round(secs, 4),
                                  round(self.lower_pending, 4),
                                  self.hit_pending])
            self.key, self.sig = None, None
            self.lower_pending, self.hit_pending = 0.0, False
        elif event == SAVED:
            self.acc["saved_s"] += secs

    def on_event(self, event, **kw):
        if event == HITS:
            self.acc["hits"] += 1
            self.hit_pending = True
        elif event == MISSES:
            self.acc["misses"] += 1

    def write(self, rec: dict):
        line = (json.dumps(rec, separators=(",", ":")) + "\n").encode()
        fd = os.open(self.path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            os.write(fd, line)
        finally:
            os.close(fd)

    def flush_test(self, nodeid: str, outcome: str | None = None):
        end = time.time()
        rec = dict(nodeid=nodeid, file=nodeid.split("::")[0],
                   worker=self.worker, start=round(self.start, 3),
                   end=round(end, 3), wall=round(end - self.start, 3),
                   outcome=outcome,
                   **{k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in self.acc.items()},
                   compiles=self.compiles,
                   sig={k[0]: self.sigs[k[0]] for k in self.compiles
                        if k[0] in self.sigs})
        self.write(rec)
        self._reset()


_ACCOUNT: _Account | None = None


def pytest_configure(config):
    global _ACCOUNT
    path = os.environ.get(ENV)
    if not path or _ACCOUNT is not None:
        return
    if getattr(config.option, "numprocesses", None) and \
            "PYTEST_XDIST_WORKER" not in os.environ:
        return  # the xdist controller runs no test
    import jax
    from jax import monitoring
    acc = _Account(os.path.abspath(path))
    jax.config.update("jax_log_compiles", True)
    for name in (*READ, *QUIET):
        lg = logging.getLogger(name)
        lg.propagate = False
        if name in READ:
            lg.setLevel(READ[name])
            lg.addHandler(acc)
        else:
            lg.addHandler(logging.NullHandler())
    monitoring.register_event_duration_secs_listener(acc.on_duration)
    monitoring.register_event_listener(acc.on_event)
    monitoring.register_scalar_listener(acc.on_scalar)
    _ACCOUNT = acc


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    acc = _ACCOUNT
    if acc is None:
        yield
        return
    if acc.compiles or acc.acc["trace_s"]:  # work since the last test
        acc.flush_test(f"<collect:{acc.worker}>")
    acc._reset()
    yield
    acc.flush_test(item.nodeid, acc.outcome)


def pytest_runtest_logreport(report):
    acc = _ACCOUNT
    if acc is not None and report.outcome != "passed" and \
            acc.outcome == "passed":
        acc.outcome = report.outcome


def pytest_sessionfinish(session):
    acc = _ACCOUNT
    if acc is not None:
        acc.write(dict(session=acc.worker, start=round(acc.t0, 3),
                       end=round(time.time(), 3)))


# ------------------------------------------------------------- summary


def load(path):
    tests, sessions = [], []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            (sessions if "session" in rec else tests).append(rec)
    return tests, sessions


def repeated(tests):
    """Keys compiled more than once: {key: dict(n, tests, files, s, sig)}."""
    out: dict[str, dict] = {}
    for t in tests:
        for key, back, low, _hit in t["compiles"]:
            e = out.setdefault(key, dict(n=0, tests=set(), files=set(),
                                         s=0.0, sig=""))
            e["n"] += 1
            e["tests"].add(t["nodeid"])
            e["files"].add(t["file"])
            e["s"] += back + low
            e["sig"] = e["sig"] or t.get("sig", {}).get(key, "")
    return {k: v for k, v in out.items() if v["n"] > 1}


def summary(path, top=25, out=sys.stdout):
    tests, sessions = load(path)
    p = lambda *a: print(*a, file=out)  # noqa: E731
    if not tests:
        p("no tests recorded")
        return
    t0 = min(t["start"] for t in tests)
    t1 = max(t["end"] for t in tests)
    comp = lambda t: t["trace_s"] + t["lower_s"] + t["backend_s"]  # noqa: E731
    p(f"tests {len(tests)}  span {t1 - t0:.1f} s  worker time "
      f"{sum(t['wall'] for t in tests):.1f} s  compile (trace+lower+backend) "
      f"{sum(comp(t) for t in tests):.1f} s  hits "
      f"{sum(t['hits'] for t in tests)}  misses "
      f"{sum(t['misses'] for t in tests)}  saved "
      f"{sum(t['saved_s'] for t in tests):.1f} s")

    files: dict[str, dict] = {}
    for t in tests:
        f = files.setdefault(t["file"], dict(n=0, wall=0.0, trace=0.0,
                                             lower=0.0, back=0.0, worker="",
                                             start=t["start"], end=t["end"]))
        f["n"] += 1
        f["wall"] += t["wall"]
        f["trace"] += t["trace_s"]
        f["lower"] += t["lower_s"]
        f["back"] += t["backend_s"]
        f["worker"] = t["worker"]
        f["start"] = min(f["start"], t["start"])
        f["end"] = max(f["end"], t["end"])
    p(f"\nfiles by seconds (top {top} of {len(files)})")
    p("| file | tests | worker | starts at s | wall s | trace s | lower s "
      "| backend s |")
    p("| --- | --- | --- | --- | --- | --- | --- | --- |")
    for name, f in sorted(files.items(), key=lambda kv: -kv[1]["wall"])[:top]:
        p(f"| {name} | {f['n']} | {f['worker']} | {f['start'] - t0:.0f} | "
          f"{f['wall']:.1f} | {f['trace']:.1f} | {f['lower']:.1f} | "
          f"{f['back']:.1f} |")

    workers: dict[str, dict] = {}
    for t in tests:
        w = workers.setdefault(t["worker"], dict(busy=0.0, n=0, end=0.0))
        w["busy"] += t["wall"]
        w["n"] += 1
        w["end"] = max(w["end"], t["end"])
    p("\nworkers")
    p("| worker | tests | busy s | last test ends at s | idle tail s |")
    p("| --- | --- | --- | --- | --- |")
    for name, w in sorted(workers.items()):
        p(f"| {name} | {w['n']} | {w['busy']:.1f} | {w['end'] - t0:.0f} | "
          f"{t1 - w['end']:.0f} |")

    rep = repeated(tests)
    p(f"\nkeys compiled more than once ({len(rep)}; top {top} by seconds)")
    p("| key | compiles | tests | files | total s | shapes |")
    p("| --- | --- | --- | --- | --- | --- |")
    for key, e in sorted(rep.items(), key=lambda kv: -kv[1]["s"])[:top]:
        sig = e["sig"] if len(e["sig"]) <= 80 else e["sig"][:77] + "..."
        p(f"| {key} | {e['n']} | {len(e['tests'])} | "
          f"{', '.join(sorted(os.path.basename(x) for x in e['files']))} | "
          f"{e['s']:.1f} | {sig} |")
    total = sum(e["s"] for e in rep.values())
    once = sum(e["s"] / e["n"] for e in rep.values())
    p(f"\nrepeated compiles: {total:.1f} s in all, {total - once:.1f} s "
      f"beyond the first compile of each key")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--summary", required=True, metavar="FILE")
    ap.add_argument("--top", type=int, default=25)
    a = ap.parse_args(argv)
    summary(a.summary, a.top)


if __name__ == "__main__":
    main()
