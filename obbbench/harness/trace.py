"""The traced run's record: ``torch.profiler`` over the window, kept in
memory, reduced to device kernels (name, start, end, the span that held
their launch), host spans (the program's own ``obb/`` ranges and the
benchmark's window) and the program's stage totals, the device's busy
time, and the breakdown of the result line.

A kernel belongs to the innermost span whose host interval holds the
start of the operator that launched it (the profiler links them by
correlation id). The kinds of kernels are the frozen table
``KERNEL_KINDS`` below, read by ``kernel_kind``.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

SPAN_PREFIX = "obb/"
WINDOW = "obb/window"

# kinds of device work, by a substring of the kernel's name (first match)
KERNEL_KINDS = (
    ("edt", ("edt_pass",)),
    ("conv_matmul", ("conv", "gemm", "xmma", "cudnn", "cutlass", "sm90_",
                     "implicit", "winograd")),
    ("sort", ("sort", "radix")),
    ("copy", ("memcpy", "memset")),
)


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "elementwise_other"


def union_length(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


@dataclass
class Kernel:
    name: str
    start: float      # seconds on the trace's clock
    end: float
    span: str         # innermost ``obb/`` span of its launch

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    """What the layer-metric readers read."""
    kernels: list = field(default_factory=list)
    spans: list = field(default_factory=list)    # (name, start, end)
    window: tuple = (0.0, 0.0)
    stages: dict = field(default_factory=dict)   # program stage totals, s
    units: int = 0                               # sheets, maps or steps
    _timeline: tuple | None = field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        a, b = self.window
        return union_length((max(k.start, a), min(k.end, b))
                            for k in self.kernels if k.end > a and k.start < b)

    def kernel_seconds(self, span_prefix: str = "", kind_not: str = "",
                       kind: str = "") -> float:
        return sum(k.seconds for k in self.kernels
                   if k.span.startswith(span_prefix)
                   and (not kind or kernel_kind(k.name) == kind)
                   and (not kind_not or kernel_kind(k.name) != kind_not))

    def breakdown(self, n: int = 10) -> dict:
        by_name: dict = {}
        for k in self.kernels:
            by_name[k.name] = by_name.get(k.name, 0.0) + k.seconds
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps: dict = {}
        end = self.window[0]
        for k in sorted(self.kernels, key=lambda k: k.start):
            if k.start > end:
                label = self.host_span_at(end) or "outside any span"
                gaps[label] = gaps.get(label, 0.0) + (k.start - end)
            end = max(end, k.end)
        if self.window[1] > end:
            label = self.host_span_at(end) or "outside any span"
            gaps[label] = gaps.get(label, 0.0) + (self.window[1] - end)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}

    def host_span_at(self, t: float) -> str:
        """The innermost span (not the window) open on the host at ``t``."""
        if self._timeline is None:
            self._timeline = _timeline(
                [sp for sp in self.spans if sp[0] != WINDOW])
        times, labels = self._timeline
        i = bisect.bisect_right(times, t) - 1
        return labels[i] if i >= 0 else ""


def _timeline(spans: list) -> tuple:
    """(boundary times, innermost span from each boundary on) of spans
    given as (name, start, end)."""
    marks = sorted([(s, 1, i) for i, (_, s, _e) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, _s, e) in enumerate(spans)])
    open_, times, labels = [], [], []
    for t, is_start, i in marks:
        if is_start:
            open_.append(i)
        elif i in open_:
            open_.remove(i)
        times.append(t)
        labels.append(spans[open_[-1]][0] if open_ else "")
    return times, labels


@contextlib.contextmanager
def span(name: str):
    """A benchmark span: a ``record_function`` range named ``obb/<name>``."""
    import torch

    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def program_stages():
    """The program's stage timers (``utils/profiling.timed``, which open
    their own ``obb/stage/<name>`` spans), their totals restarted."""
    from oriented_object_detection_tpu_torch.utils import profiling as P

    P.reset()
    return P


def _device_types():
    from torch.autograd import DeviceType

    return DeviceType.CPU, DeviceType.CUDA


def reduce(prof, stages: dict, units: int) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``."""
    CPU, CUDA = _device_types()
    events = prof.profiler.kineto_results.events()
    ops, spans, kernels = {}, [], []
    for e in events:
        s = e.start_ns() / 1e9
        t = s + e.duration_ns() / 1e9
        if e.device_type() == CUDA:
            # the device side of a record_function range is no kernel
            if not e.name().startswith(SPAN_PREFIX):
                kernels.append((e.name(), s, t, e.linked_correlation_id()))
        elif e.device_type() == CPU:
            name = e.name()
            if name.startswith(SPAN_PREFIX):
                spans.append((name, s, t))
            elif e.linked_correlation_id() == 0:
                ops[e.correlation_id()] = s
    tr = Trace(spans=spans, stages=stages, units=units)
    win = [sp for sp in spans if sp[0] == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window span")
    tr.window = (win[0][1], win[0][2])
    for name, s, t, corr in kernels:
        launch = ops.get(corr)
        tr.kernels.append(Kernel(name, s, t, tr.host_span_at(launch)
                                 if launch is not None else ""))
    return tr
