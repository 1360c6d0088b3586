"""What a run reads by name: ``BENCHMARK.json`` at the checkout's root, a
cell's file ``workloads/<cell>.json``, its configuration's file
``configs/<config>.json``, its traffic driver ``traffic/<kind>.py``, the
configuration's architecture ``archs/<model>.py`` (the configuration's
``model`` lowercased, ``-`` as ``_``), and one module a metric:
``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``. Adding a
cell, a configuration, an architecture or a metric adds files and
entries; no file here changes."""

from __future__ import annotations

import hashlib
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


def load_module(path: str):
    """The module in file ``path``, loaded once a process: its name holds
    a digest of the path, so files of one name in two folders stay two
    modules."""
    path = os.path.abspath(path)
    stem = os.path.basename(path)[:-len(".py")].replace(".", "_")
    name = f"obbbench_{hashlib.sha1(path.encode()).hexdigest()[:12]}_{stem}"
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
    data_dir: str | None = None

    def module(self, group: str, name: str):
        """``<group>/<name>.py``, from the test's data directory where it
        holds that file, else from the benchmark's folder."""
        path = os.path.join(BENCH_DIR, group, f"{name}.py")
        if self.data_dir:
            own = os.path.join(self.data_dir, group, f"{name}.py")
            path = own if os.path.exists(own) else path
        return load_module(path)

    @property
    def driver(self):
        return self.module("traffic", self.workload["driver"])

    @property
    def arch(self):
        """The architecture module: ``program_detector(cell, device)``,
        ``reference_models(cfg, root, device, precision)`` and
        ``forward_flops(cfg, tile)``; optionally the reference's own
        ``reference_input(tiles)`` (uint8 BGR ``[n, ts, ts, 3]`` on the
        device to the model's float32 NCHW input) and
        ``reference_decode(out, tile)`` (the model's raw outputs to
        ``xywhr`` ``[B, A, 5]`` in tile pixels, radians in any range, and
        ``scores`` ``[B, A, nc]`` in [0, 1]), YOLO's where it defines
        none. Everything after the decode is shared by every
        architecture (``reference/detect.py``): an architecture brings its
        network, not its own NMS policy."""
        return self.module(
            "archs", self.config["model"].lower().replace("-", "_"))


def _applies(metric: dict, cell: str, reported: set | None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_cell(name: str, root: str = ROOT, data_dir: str | None = None
              ) -> Cell:
    """The cell ``name`` as ``BENCHMARK.json`` lists it, with its cell and
    configuration files. ``root`` is the checkout (the checkpoints are
    relative to it); ``data_dir``, when a test gives one, holds a
    ``BENCHMARK.json``, ``workloads/`` and ``configs/`` of its own, and may
    hold modules of its own (``archs/``, ``traffic/``, ...)."""
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
    return Cell(name, wl, cfg, e2e, per_layer, root, data_dir=data_dir)
