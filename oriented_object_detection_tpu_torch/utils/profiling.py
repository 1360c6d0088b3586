"""Stage timers and the device trace.

* ``timed(name)`` - a context manager that adds the host wall time of its
  block to a process-wide registry under ``name`` (the multi-map detect
  path records ``detect/h2d``, ``detect/dispatch``, ``detect/fetch``,
  ``detect/merge_{tile_size}`` and ``detect/fusion``). It never
  synchronizes the device: a synchronize inside a span would serialize the
  pipeline it measures. A caller that wants a span to hold the device's
  time synchronizes inside it.
* ``trace(log_dir)`` - a ``torch.profiler`` trace of the block (CPU, and
  the card's kernels where there is one), written as a Chrome trace.
* ``report()`` / ``print_report()`` - per-stage calls, total and mean.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

_STAGES: dict[str, list[float]] = defaultdict(list)
_ENABLED = True


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def reset() -> None:
    _STAGES.clear()


@contextlib.contextmanager
def timed(name: str):
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _STAGES[name].append(time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block; the trace goes to
    ``log_dir/trace.json`` (Perfetto and chrome://tracing read it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def report() -> dict[str, dict]:
    out = {}
    for name, times in sorted(_STAGES.items()):
        out[name] = {
            "calls": len(times),
            "total_s": sum(times),
            "mean_ms": sum(times) / len(times) * 1000.0,
        }
    return out


def print_report() -> None:
    rep = report()
    if not rep:
        return
    width = max(len(k) for k in rep)
    print(f"{'stage'.ljust(width)}  calls  total(s)  mean(ms)")
    for k, v in rep.items():
        print(f"{k.ljust(width)}  {v['calls']:5d}  {v['total_s']:8.3f}"
              f"  {v['mean_ms']:8.2f}")
