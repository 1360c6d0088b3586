"""Stage timers and spans: the port's one tracing module.

* ``span(name)`` - while a ``torch.profiler`` is collecting, a
  ``record_function`` range named ``obb/<name>``, so the host's spans lie
  on the profiler's clock beside the card's kernels; otherwise one check
  of the profiler's enabled flag and a shared do-nothing context, with no
  ``record_function`` made.
* ``timed(name)`` - a context manager that adds the host wall time of its
  block to a process-wide registry under ``name`` and opens
  ``span("stage/" + name)``. The multi-map detect path records
  ``detect/h2d``, ``detect/dispatch``, ``detect/fetch`` (holding
  ``detect/wait``, the host's wait on the card for one group),
  ``detect/merge_{tile_size}`` and ``detect/fusion``. It never
  synchronizes the device: a synchronize inside a span would serialize
  the pipeline it measures. A caller that wants a span to hold the
  device's time synchronizes inside it.
* ``report()`` - per stage calls, total and mean.

Besides the stage spans the detect path opens ``tiles_<tile>``,
``forward_<tile>``, ``decode_raw`` and ``postprocess_batch``
(``infer/pipeline.py``), and inside ``forward_<tile>`` one
``forward_area_attn`` a YOLO12 area-attention block and one
``forward_depthwise`` a CSPNeXt block's depthwise ConvBN
(``models/layers.py``).
"""

from __future__ import annotations

import contextlib
import time

import torch

SPAN_PREFIX = "obb/"

_NO_SPAN = contextlib.nullcontext()
_STAGES: dict[str, list] = {}   # name -> [calls, total seconds]
_ENABLED = True


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def reset() -> None:
    _STAGES.clear()


def span(name: str):
    """``obb/<name>`` on the profiler's timeline while one is collecting."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def timed(name: str):
    with span("stage/" + name):
        if not _ENABLED:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            stage = _STAGES.setdefault(name, [0, 0.0])
            stage[0] += 1
            stage[1] += time.perf_counter() - t0


def report() -> dict[str, dict]:
    return {name: {"calls": calls, "total_s": total,
                   "mean_ms": total / calls * 1000.0}
            for name, (calls, total) in sorted(_STAGES.items())}
