"""Traffic driver: one map at a time through ``TiledDetector.detect_image``
(the CLI's default ``detect``), closed loop, one client.

Parameters: ``shapes``, the (height, width) of the maps in turn; ``pool``
distinct seeded maps, cycled for as long as the window lasts;
``warm_rounds`` passes over the pool at set-up. The record: each map's
latency from the call to its fused rows, its megapixels and its forward
FLOPs."""

from __future__ import annotations

import time

from obbbench.harness import detection as DT

release = DT.release
readings = DT.readings
reference = DT.reference


def setup(cell, seed: int, device):
    p = cell.workload["params"]
    shapes = [tuple(p["shapes"][i % len(p["shapes"])])
              for i in range(p["pool"])]
    sess = DT.Session(cell, seed, device)
    DT.make_pool(sess, shapes)
    sess.det = DT.build_detector(cell, device)
    for _ in range(p["warm_rounds"]):
        for m in sess.pool:
            sess.det.detect_image(m)
    return sess


def window(sess, seconds: float, max_units: int | None) -> dict:
    n_max = max_units or 1_000_000
    sess.results.clear()
    lat, units = [], []
    t0 = time.perf_counter()
    done = 0.0
    while len(units) < n_max:
        u = len(units) % len(sess.pool)
        t = time.perf_counter()
        res = sess.det.detect_image(sess.pool[u])
        done = time.perf_counter() - t0
        lat.append(done - (t - t0))
        units.append(u)
        sess.results.append((u, res))
        if done >= seconds:
            break
    return {"window_s": done, "units": len(units), "latency_s": lat,
            "mpix": [sess.pool[u].shape[0] * sess.pool[u].shape[1] / 1e6
                     for u in units],
            "flops": sum(sess.flops_per_map[u] for u in units)}
