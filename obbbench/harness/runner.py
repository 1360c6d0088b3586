"""One run of one cell: set-up, the measured window, the traced reading of
the per-layer metrics, the check against the plain reference, and the
result line.

A traffic driver (``traffic/<kind>.py``) provides

* ``setup(cell, seed, device) -> session``: builds the program's objects
  and the inputs from the seed, and warms up every shape the window uses;
* ``window(session, seconds, max_units) -> record``: the closed loop (a
  traced window stops after the cell's ``trace_units`` sheets, maps or
  steps);
  ``record`` holds ``window_s`` and ``units``, and what the cell's metric
  modules read;
* ``release(session)``: drops the program's state, keeping its outputs;
* ``reference(session, precision, fault=None) -> outputs``: the plain
  reference over the sampled inputs;
* ``readings(session, outputs) -> {number: value}``: the numbers that
  ``correct`` compares, of the program's outputs (``outputs=None``) or of
  other outputs, each against the reference in float32.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from . import trace as TR

FORBIDDEN = ("jax", "jaxlib", "flax", "oriented_object_detection_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device, chips: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print) -> dict:
    """The result line's object, the checks last."""
    drv = cell.driver
    on_card = device.type == "cuda"
    sess = drv.setup(cell, seed, device)
    _sync(device)
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    tr = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        stages = TR.program_stages()
        with profile(activities=acts) as prof:
            with TR.span("window"):
                record = drv.window(sess, seconds,
                                    cell.workload["trace_units"])
        tr = TR.reduce(prof, {k: v["total_s"] for k, v in
                              stages.report().items()}, record["units"])
        del prof
    else:
        record = drv.window(sess, seconds, None)
    _sync(device)
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    record.update(setup_s=setup_s, peak_bytes=window_peak)

    lat = record.get("latency_s")
    log(f"[obbbench] window {record['window_s']:.3f} s, {record['units']} "
        f"units" + (f", latency quartiles {statistics.quantiles(lat, n=4)}"
                    if lat and len(lat) > 1 else ""))
    metrics = {}
    group = "layer_metrics" if trace else "end_to_end"
    for m in (cell.per_layer if trace else cell.end_to_end):
        mod = cell.module(group, m["name"])
        v = mod.value(tr, record, cell) if trace else mod.value(record, cell)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    drv.release(sess)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = drv.readings(sess, None)
    limits = cell.workload["limits"]
    checks = {k: {"value": got[k], "limit": lim} for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    log(f"[obbbench] reference check {time.perf_counter() - t0:.1f} s; "
        f"readings {got}")
    result = {"correct": correct, "attempted": record["units"],
              "failed": record.get("failed", 0), "metrics": metrics,
              "device": device_info(device, cell.workload["chips"],
                                    max(setup_peak, window_peak))}
    if trace:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    for k, c in checks.items():
        log(f"check {k} = {c['value']!r} limit {c['limit']!r}")
    result["checks"] = checks
    # last, once the metric modules, the release and the reference have run
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX loaded in this process: {found}")
    return result
