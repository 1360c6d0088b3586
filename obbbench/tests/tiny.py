"""The cells as the tests run them: ``BENCHMARK.json`` merged with the
cells held back from it (``obbbench/held_back.json``), at their own sizes
or at a size the CPU holds (the YOLO11n-OBB checkpoints, small maps, a
few tiles; every other value, limits and knobs, is the real cell's).

The small values are files, one a cell and one a configuration:
``tiny/workloads/<cell>.json`` (``params`` merged into the cell's, any
other key replacing the cell's) and ``tiny/configs/<config>.json`` (keys
replacing the configuration's)."""

from __future__ import annotations

import json
import os

from obbbench.harness import spec

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")


def merged_bench() -> dict:
    """``BENCHMARK.json`` with the held-back cells' entries added."""
    bench = spec.read_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    held = spec.read_json(os.path.join(spec.BENCH_DIR, "held_back.json"))
    for key in ("configs", "workloads"):
        bench[key] += held[key]
    for key in ("end_to_end", "per_layer"):
        have = {m["name"]: m for m in bench[key]}
        for m in held[key]:
            if m["name"] in have and "workloads" in have[m["name"]]:
                have[m["name"]]["workloads"] += m["workloads"]
            elif m["name"] not in have:
                bench[key].append(m)
    return bench


def _first(*paths: str) -> str:
    return next((p for p in paths if os.path.exists(p)), paths[-1])


def tiny_file(kind: str, name: str, tmp: str | None = None) -> str:
    """The tiny-size file of a cell (``kind`` "workloads") or a
    configuration ("configs"): the test's own in ``tmp/tiny/`` where it
    holds one, else the benchmark's."""
    return _first(*([os.path.join(tmp, "tiny", kind, f"{name}.json")]
                    if tmp else []),
                  os.path.join(TINY, kind, f"{name}.json"))


def sizes(kind: str, name: str, tmp: str | None = None) -> dict:
    path = tiny_file(kind, name, tmp)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{kind[:-1]} {name!r} has no size the CPU holds: add "
            f"{os.path.relpath(path, spec.ROOT)} (see obbbench/README.md)")
    return spec.read_json(path)


def make(tmp: str, small: bool = True, **config_changes) -> str:
    """A data directory ``tmp`` with the merged ``BENCHMARK.json`` and
    every cell and configuration, small unless ``small`` is false;
    ``config_changes`` go into every configuration. What a test put in
    ``tmp`` beforehand (``BENCHMARK.json``, ``configs/``, ``workloads/``,
    ``tiny/``) is read before the benchmark's own files."""
    for d in ("configs", "workloads"):
        os.makedirs(os.path.join(tmp, d), exist_ok=True)
    own_bench = os.path.join(tmp, "BENCHMARK.json")
    bench = (spec.read_json(own_bench) if os.path.exists(own_bench)
             else merged_bench())
    with open(own_bench, "w") as f:
        json.dump(bench, f)
    for c in bench["configs"]:
        path = os.path.join(tmp, "configs", f"{c['name']}.json")
        cfg = spec.read_json(_first(path, os.path.join(spec.ROOT, c["file"])))
        if small:
            cfg.update(sizes("configs", c["name"], tmp))
        cfg.update(config_changes)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for w in bench["workloads"]:
        path = os.path.join(tmp, "workloads", f"{w['name']}.json")
        wl = spec.read_json(_first(path, os.path.join(
            spec.BENCH_DIR, "workloads", f"{w['name']}.json")))
        if small:
            small_wl = sizes("workloads", w["name"], tmp)
            wl["params"].update(small_wl.get("params", {}))
            wl.update({k: v for k, v in small_wl.items() if k != "params"})
        with open(path, "w") as f:
            json.dump(wl, f)
    return tmp
