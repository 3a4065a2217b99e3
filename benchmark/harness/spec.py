"""Find a cell's files by the names ``BENCHMARK.json`` gives.

- a configuration: ``configs/<config>.json``;
- a traffic mix: ``traffic/<traffic>.json`` (parameters the one driver,
  :mod:`harness.loop`, reads);
- the kind of unit a traffic's ``kind`` names: ``kinds/<kind>.py``
  (``setup``, ``unit``, ``done``, ``reference`` and ``numbers``: what a
  frame or a fit step is, and how the check compares it);
- a cell's comparison limits and route: ``checks/<workload>.json``;
- a metric's reader, end-to-end or per-layer: ``metrics/<name>.py``
  (``read(record)`` returns the number, or None when it finds nothing to
  read; ``RANGES``, if given, lists the program's (module, function)
  pairs the traced stretch wraps in ranges for it);
- a kernel's roofline count: ``roofline/<kernel>.py`` (``count(world)``
  returns (operations, bytes) of one launch on the program's world);
- a fault planted under the timed path: ``faults/<name>.py``
  (``planted()``, and ``KINDS``, the kinds of unit it applies to).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The Python file at ``path`` as a fresh module named ``name`` (file
    names may hold dots, so no import by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list      # the benchmark's entries this cell reports
    per_layer: list
    run_seconds: int
    base: str             # the benchmark's folder
    modules: dict = dataclasses.field(default_factory=dict, repr=False)

    def _module(self, folder: str, name: str):
        key = (folder, name)
        if key not in self.modules:
            self.modules[key] = load_module(
                os.path.join(self.base, folder, f"{name}.py"),
                f"bench_{folder}_{name.replace('.', '_')}")
        return self.modules[key]

    def reader(self, metric: str):
        return self._module("metrics", metric).read

    @property
    def kind(self):
        """``kinds/<kind>.py`` of the cell's traffic."""
        return self._module("kinds", self.traffic["kind"])

    def ranges(self) -> list:
        """The program's (module, function) pairs that the cell's
        per-layer metrics ask the traced stretch to wrap (each metric
        file's ``RANGES``), in order, once each."""
        out = []
        for m in self.per_layer:
            for r in getattr(self._module("metrics", m["name"]), "RANGES",
                             ()):
                if tuple(r) not in out:
                    out.append(tuple(r))
        return out


def _reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, root: str = ROOT, base: str = HERE,
              bench: dict | None = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` (or of ``bench``),
    its files under ``base``.  A per-layer metric without ``workloads``
    is reported wherever the end-to-end metric it moves is."""
    if bench is None:
        bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({', '.join(cells)})")
    w = cells[workload]
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (_reports(m, workload) if "workloads" in m
                     else m["moves"] in names)]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=read_json(os.path.join(base, "configs",
                                      f"{w['config']}.json")),
        traffic=read_json(os.path.join(base, "traffic",
                                       f"{w['traffic']}.json")),
        check=read_json(os.path.join(base, "checks", f"{workload}.json")),
        end_to_end=e2e, per_layer=per_layer,
        run_seconds=int(bench["run_seconds"]), base=base)


def roofline_count(base: str, kernel: str):
    """``count`` of ``roofline/<kernel>.py``."""
    return load_module(os.path.join(base, "roofline", f"{kernel}.py"),
                       f"bench_roofline_{kernel}").count


def fault_names(base: str = HERE) -> list:
    """The faults under ``faults/``, by name."""
    return sorted(f[:-3] for f in os.listdir(os.path.join(base, "faults"))
                  if f.endswith(".py") and not f.startswith("_"))


def load_fault(name: str, base: str = HERE):
    """``faults/<name>.py``."""
    return load_module(os.path.join(base, "faults", f"{name}.py"),
                       f"bench_fault_{name}")
