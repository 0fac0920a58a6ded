"""BENCHMARK.json resolves, cell by cell, to its configuration, traffic,
limits and per-layer readers by name, within the contract's shapes."""
import json
import os
import re

import pytest

from portbench import cell as cell_mod
from portbench import harness

BENCH = cell_mod.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_workload_resolves(name):
    c = cell_mod.resolve(name)
    kw = c.settings()
    assert kw["dim_in"] == 3 and kw["dtype"] == "float64"
    assert kw["plot_int"] == -1 and kw["chk_int"] == -1
    for k in ("warm_steps", "perturbation", "check_steps", "trace_steps"):
        assert k in c.traffic
    assert c.limits is not None, "every cell has its limits file"
    assert set(c.limits) == set(LIMIT_KEYS[c.multilevel])
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.load_reader(m["name"]))


FIELDS = [f"{t}.{f}" for t in ("start", "step") for f in ("u", "s", "gp", "p")]
LIMIT_KEYS = {False: FIELDS + ["start.dt"],
              True: FIELDS + ["start.dt", "hierarchy"]}


def test_benchmark_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(cell_mod.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(
            cell_mod.HERE, "traffic", w["traffic"] + ".json"))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        assert set(m["workloads"]) <= set(CELLS)
