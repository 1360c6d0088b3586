"""The steady-state readers of the folder cell (``harness/steady.py``): the
known answer on a canned three-group stream, nothing with fewer than two
waits, and the program's own wait spans found in a CPU-profiled stream of
the small cell."""

from __future__ import annotations

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tiny
from obbbench.harness import spec
from obbbench.harness import steady as ST
from obbbench.harness import trace as TR

K = TR.Kernel
CPU = torch.device("cpu")
READERS = ("steady_idle_share", "dispatch_idle_ms", "merge_idle_ms",
           "wait_ms")


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    full = tiny.make(str(tmp_path_factory.mktemp("steady")), small=False)
    return spec.load_cell("dual_folder_sheets", spec.ROOT, full)


def read(c, tr, rec) -> dict:
    return {n: c.module("layer_metrics", f"{n}.detect_folder").value(
        tr, rec, c) for n in READERS}


def canned_stream(waits: int = 3) -> TR.Trace:
    """Three groups of a stream, chunk 1, over a 10 s window. Each stage
    span and wait is doubled by a span of the same name nested inside it,
    which the readers fold into one. The steady
    window is 2.0-5.7 s; the card is idle in it at 2.0-2.2 (the refill of
    dispatch 1), 4.4-4.7 (0.1 s in wait 1, 0.2 s in dispatch 2) and
    5.3-5.5 (in merge 1 and fusion 1)."""
    stages = [("dispatch", 0.0, 0.5), ("h2d", 0.5, 0.6),
              ("fetch", 0.6, 2.0), ("wait", 0.6, 2.0),
              ("dispatch", 2.0, 2.6), ("merge_128", 2.6, 2.9),
              ("merge_416", 2.9, 3.0), ("fusion", 3.0, 3.2),
              ("h2d", 3.2, 3.3), ("fetch", 3.3, 4.5), ("wait", 3.3, 4.5),
              ("dispatch", 4.5, 5.0), ("merge_128", 5.0, 5.3),
              ("merge_416", 5.3, 5.4), ("fusion", 5.4, 5.6),
              ("fetch", 5.6, 7.0), ("wait", 5.7, 7.0),
              ("merge_128", 7.0, 7.5), ("fusion", 7.5, 7.7)]
    dropped = [i for i, st in enumerate(stages) if st[0] == "wait"][waits:]
    spans = [("obb/window", 0.0, 10.0)]
    for name, s, e in (st for i, st in enumerate(stages)
                       if i not in dropped):
        spans += [(f"obb/stage/detect/{name}", s, e),
                  (f"obb/stage/detect/{name}", s + 0.001, e - 0.001)]
    spans += [("obb/forward_128", 2.1, 2.3), ("obb/tiles_128", 4.6, 4.65)]
    kernels = [K("conv", 0.1, 2.0, "obb/forward_128"),
               K("conv", 2.2, 3.0, "obb/forward_128"),
               K("add", 2.9, 4.4, "obb/forward_416"),
               K("conv", 4.7, 5.3, "obb/forward_128"),
               K("conv", 5.5, 6.9, "obb/forward_128")]
    return TR.Trace(kernels=kernels, spans=spans, window=(0.0, 10.0),
                    units=3)


REC = {"mpix": [1.0, 2.0, 4.0], "units": 3, "flops": 3e12}


def test_known_answers_on_a_canned_stream(cell):
    got = read(cell, canned_stream(), REC)
    # groups 1 and 2 are dispatched inside the window: 6 Mpix
    assert got["steady_idle_share"] == pytest.approx(100 * 0.7 / 3.7)
    assert got["dispatch_idle_ms"] == pytest.approx(1e3 * 0.4 / 6)
    assert got["merge_idle_ms"] == pytest.approx(1e3 * 0.2 / 6)
    # wait 1 (1.2 s, nested double folded) over group 1's 2 Mpix
    assert got["wait_ms"] == pytest.approx(1e3 * 1.2 / 2)


def test_groups_of_several_sheets(cell):
    """With chunk 2 a group's megapixels are its two sheets'."""
    c = dataclasses.replace(cell, workload={
        **cell.workload, "params": {**cell.workload["params"], "chunk": 2}})
    rec = {**REC, "mpix": [0.5, 0.5, 1.0, 1.0, 2.0, 2.0], "units": 6}
    assert read(c, canned_stream(), rec) == pytest.approx(
        read(cell, canned_stream(), REC))


@pytest.mark.parametrize("waits", [0, 1])
def test_fewer_than_two_waits_give_nothing(cell, waits):
    got = read(cell, canned_stream(waits), REC)
    assert got == {n: None for n in READERS}


def test_two_waits_leave_no_wait_inside(cell):
    """The window then holds a refill but no whole wait."""
    got = read(cell, canned_stream(2), REC)
    assert got["wait_ms"] is None
    assert got["steady_idle_share"] is not None


def test_outermost_folds_nested_spans_of_a_name():
    tr = canned_stream()
    assert ST.outermost(tr, lambda n: n == ST.WAIT) == [
        (0.6, 2.0), (3.3, 4.5), (5.7, 7.0)]
    assert ST.merged([(0, 1), (0.5, 2), (3, 4)]) == [(0, 2), (3, 4)]
    assert ST.intersect([(0, 2), (3, 4)], [(1, 3.5)]) == [(1, 2), (3, 3.5)]


def test_cpu_stream_gives_the_program_waits(tmp_path):
    """The small cell's traced window, run as the runner runs it, on the
    CPU: ``reduce`` finds the program's wait spans, one a group, and
    ``wait_ms`` reads them; the device readers find no kernels and give
    nothing."""
    c = spec.load_cell("dual_folder_sheets", spec.ROOT,
                       tiny.make(str(tmp_path)))
    drv = c.driver
    sess = drv.setup(c, 2 ** 31 + 17, CPU)
    stages = TR.program_stages()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TR.span("window"):
            record = drv.window(sess, 600.0, c.workload["trace_units"])
    tr = TR.reduce(prof, {k: v["total_s"] for k, v in
                          stages.report().items()}, record["units"])
    groups = c.workload["trace_units"]
    assert sum(n == ST.WAIT for n, *_ in tr.spans) == groups
    assert len(ST.outermost(tr, lambda n: n == ST.WAIT)) == groups
    assert stages.report()["detect/wait"]["calls"] == groups
    # the program opens every span the readers read, each once
    for name in ("obb/forward_128", "obb/forward_416", "obb/decode_raw",
                 "obb/postprocess_batch", "obb/tiles_128",
                 "obb/stage/detect/fusion"):
        n = sum(s[0] == name for s in tr.spans)
        assert n > 0, name
        assert len(ST.outermost(tr, lambda s, _n=name: s == _n)) == n, name
    got = read(c, tr, record)
    assert got["wait_ms"] is not None and got["wait_ms"] >= 0
    assert got["steady_idle_share"] is None
    assert got["dispatch_idle_ms"] is None
    assert got["merge_idle_ms"] is None
