"""A cell of BENCHMARK.json resolved to its files by name.

A cell names a configuration (``configs/<config>.json``: the physics and
numerics, as VardenConfig keys under ``settings``, and its ``gates``) and
a traffic mix (``traffic/<traffic>.json``: the grid and hierarchy under
``settings``, and the run's parameters: warm steps, the seeded velocity
perturbation, which window steps the check may draw, how many steps the
traced run profiles). Its limits are ``limits/<cell>.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def benchmark() -> Dict:
    return _load(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Optional[Dict]
    end_to_end: List[Dict]
    per_layer: List[Dict]

    def settings(self, dtype: Optional[str] = None) -> Dict:
        """VardenConfig keyword arguments: the configuration's settings,
        then the traffic's (grid, hierarchy, iterations), no output."""
        kw = dict(self.config["settings"])
        kw.update(self.traffic["settings"])
        kw.update(plot_int=-1, chk_int=-1)
        if dtype is not None:
            kw["dtype"] = dtype
        return kw

    @property
    def multilevel(self) -> bool:
        return self.settings().get("max_levs", 1) > 1


def metrics_of(entries: List[Dict], cell: str) -> List[Dict]:
    """The metrics that a cell reports: those without ``workloads`` and
    those that list it."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


def resolve(name: str) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files; KeyError for a
    name the file does not list."""
    bench = benchmark()
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    limits = os.path.join(HERE, "limits", f"{name}.json")
    return Cell(
        name=name,
        config=_load(os.path.join(ROOT, conf["file"])),
        traffic=_load(os.path.join(HERE, "traffic", f"{work['traffic']}.json")),
        limits=(_load(limits)["limits"] if os.path.exists(limits)
                else None),
        end_to_end=metrics_of(bench["end_to_end"], name),
        per_layer=metrics_of(bench["per_layer"], name))
