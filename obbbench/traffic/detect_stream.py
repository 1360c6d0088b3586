"""Traffic driver: a folder of sheets through ``TiledDetector.detect_stream``
(the CLI's ``detect --stream``), closed loop, one client.

Parameters (the cell's ``params``): ``height``, ``width`` of a sheet,
``pool`` distinct seeded sheets cycled for as long as the window lasts,
``chunk`` maps a group, ``warm_maps`` sheets streamed at set-up. The
record: every sheet completed in the window with its megapixels and the
forward FLOPs of its tiles."""

from __future__ import annotations

import time

from obbbench.harness import detection as DT

release = DT.release
readings = DT.readings
reference = DT.reference


def setup(cell, seed: int, device):
    p = cell.workload["params"]
    sess = DT.Session(cell, seed, device)
    DT.make_pool(sess, [(p["height"], p["width"])] * p["pool"])
    sess.det = DT.build_detector(cell, device)
    for _ in sess.det.detect_stream(sess.pool[:p["warm_maps"]],
                                    chunk=p["chunk"]):
        pass
    return sess


def window(sess, seconds: float, max_units: int | None) -> dict:
    p = sess.cell.workload["params"]
    n_max = max_units or 1_000_000
    order = [i % len(sess.pool) for i in range(n_max)]
    stream = sess.det.detect_stream([sess.pool[i] for i in order],
                                    chunk=p["chunk"])
    sess.results.clear()
    t0 = time.perf_counter()
    done = 0.0
    for k, res in enumerate(stream):
        done = time.perf_counter() - t0
        sess.results.append((order[k], res))
        if done >= seconds or k + 1 >= n_max:
            break
    stream.close()
    units = [order[k] for k in range(len(sess.results))]
    return {"window_s": done, "units": len(units),
            "mpix": [sess.pool[u].shape[0] * sess.pool[u].shape[1] / 1e6
                     for u in units],
            "flops": sum(sess.flops_per_map[u] for u in units)}
