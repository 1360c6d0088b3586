"""What a run reads by name: ``BENCHMARK.json`` at the checkout's root, a
cell's file ``workloads/<cell>.json``, its configuration's file
``configs/<config>.json``, its traffic driver ``traffic/<kind>.py``, and
one module a metric: ``end_to_end/<metric>.py`` and
``layer_metrics/<metric>.py``. Adding a cell, a configuration or a metric
adds files and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The module in file ``path`` under the name ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell of the benchmark with everything a run of it reads."""
    name: str
    workload: dict
    config: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: str = ROOT
    bench_dir: str = BENCH_DIR

    @property
    def driver(self):
        kind = self.workload["driver"]
        return load_module(os.path.join(self.bench_dir, "traffic",
                                        f"{kind}.py"), f"obbbench_traffic_{kind}")

    def metric_module(self, group: str, name: str):
        return load_module(os.path.join(self.bench_dir, group, f"{name}.py"),
                           f"obbbench_{group}_{name.replace('.', '_')}")


def _applies(metric: dict, cell: str, reported: set | None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_cell(name: str, root: str = ROOT, data_dir: str | None = None
              ) -> Cell:
    """The cell ``name`` as ``BENCHMARK.json`` lists it, with its cell and
    configuration files. ``root`` is the checkout (the checkpoints are
    relative to it); ``data_dir``, when a test gives one, holds a
    ``BENCHMARK.json``, ``workloads/`` and ``configs/`` of its own."""
    bench = read_json(os.path.join(data_dir or root, "BENCHMARK.json"))
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = read_json(os.path.join(data_dir or BENCH_DIR, "workloads",
                                f"{name}.json"))
    for k in ("config", "traffic", "chips"):
        if wl[k] != entry[k]:
            raise ValueError(f"{name}: {k} {wl[k]!r} in its file, "
                             f"{entry[k]!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    cfg = read_json(os.path.join(data_dir, "configs",
                                 f"{entry['config']}.json") if data_dir
                    else os.path.join(root, cfg_entry["file"]))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, None)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, wl, cfg, e2e, per_layer, root)
