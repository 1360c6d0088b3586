"""The cells as the tests run them: ``BENCHMARK.json`` merged with the
cells held back from it (``obbbench/held_back.json``), at their own sizes
or at a size the CPU holds (the YOLO11n-OBB checkpoints, small maps, a
few tiles; every other value, limits and knobs, is the real cell's)."""

from __future__ import annotations

import json
import os

from obbbench.harness import spec

SIZES = {
    "dual_folder_sheets": {"params": {"height": 640, "width": 640,
                                      "pool": 2, "warm_maps": 2}},
    "dual_single_maps": {"params": {"shapes": [[540, 500], [620, 580]],
                                    "pool": 4}, "check_maps": 3},
    "train416_b16": {"params": {"maps": 2, "map_size": 256}},
}
CONFIGS = {
    "yolo11x_obb_dual_bf16": {"model_scale": "n", "scales": [
        {"tile_size": 128, "overlap": 30,
         "checkpoint": "assets/bench_ckpts/train128.ckpt"},
        {"tile_size": 416, "overlap": 100,
         "checkpoint": "assets/bench_ckpts/train416.ckpt"}]},
    "yolo11x_obb_train416_bf16": {
        "model_scale": "n", "tile_size": 128, "overlap": 30, "batch_size": 4,
        "init_checkpoint": "assets/bench_ckpts/train128.ckpt"},
}


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


def make(tmp: str, small: bool = True, **config_changes) -> str:
    """A data directory under ``tmp`` with the merged ``BENCHMARK.json``
    and every cell and configuration, small unless ``small`` is false;
    ``config_changes`` go into every configuration."""
    for d in ("configs", "workloads"):
        os.makedirs(os.path.join(tmp, d), exist_ok=True)
    bench = merged_bench()
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for c in bench["configs"]:
        cfg = spec.read_json(os.path.join(spec.ROOT, c["file"]))
        if small:
            cfg.update(CONFIGS[c["name"]])
        cfg.update(config_changes)
        with open(os.path.join(tmp, "configs", f"{c['name']}.json"), "w") as f:
            json.dump(cfg, f)
    for w in bench["workloads"]:
        wl = spec.read_json(os.path.join(spec.BENCH_DIR, "workloads",
                                         f"{w['name']}.json"))
        if small:
            wl["params"].update(SIZES[w["name"]]["params"])
            wl.update({k: v for k, v in SIZES[w["name"]].items()
                       if k != "params"})
        with open(os.path.join(tmp, "workloads", f"{w['name']}.json"),
                  "w") as f:
            json.dump(wl, f)
    return tmp
