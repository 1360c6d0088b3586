"""The detect path's own spans (``utils/profiling.span`` and the stage
timers' spans) under ``torch.profiler`` on the CPU: a YOLO11n-OBB detector
at tile 128 in bf16 streams four maps, one group each. The spans carry the
names the benchmark reads, nest where the work happens, come one a group,
and cost no ``record_function`` while no profiler collects."""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from oriented_object_detection_tpu_torch.infer import pipeline as P
from oriented_object_detection_tpu_torch.utils import profiling as prof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")
GROUPS = 4
TS = 128


@pytest.fixture(scope="module")
def detector():
    return P.build_detector([(TS, 30, CKPT)], channels=3, model_scale="n",
                            device="cpu", compute_dtype="bfloat16")


def _maps(n: int) -> list:
    rng = np.random.RandomState(5)
    return [rng.randint(0, 256, (150 + 20 * i, 170, 3), np.uint8)
            for i in range(n)]


@pytest.fixture(scope="module")
def events(detector):
    """The profiler's host events of a stream of ``GROUPS`` maps, chunk 1:
    [(name, start us, end us, first input shape)]."""
    maps = _maps(GROUPS)
    list(detector.detect_stream(maps[:1]))      # warm-up
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as p:
        results = list(detector.detect_stream(maps, chunk=1))
    assert len(results) == GROUPS
    return [(e.name, e.time_range.start, e.time_range.end,
             e.input_shapes[0] if e.input_shapes else [])
            for e in p.events()]


def _spans(events, name: str) -> list:
    return sorted((s, e) for n, s, e, _ in events
                  if n == prof.SPAN_PREFIX + name)


def test_stream_spans_carry_the_program_names(events):
    names = {n for n, *_ in events if n.startswith(prof.SPAN_PREFIX)}
    assert names == {prof.SPAN_PREFIX + n for n in (
        "stage/detect/h2d", "stage/detect/dispatch", "stage/detect/fetch",
        "stage/detect/wait", f"stage/detect/merge_{TS}",
        "stage/detect/fusion", f"tiles_{TS}", f"forward_{TS}",
        "decode_raw", "postprocess_batch")}


@pytest.mark.parametrize("child,parent", [
    (f"forward_{TS}", "stage/detect/dispatch"),
    ("decode_raw", "stage/detect/dispatch"),
    ("postprocess_batch", "stage/detect/dispatch"),
    (f"tiles_{TS}", "stage/detect/dispatch"),
    ("stage/detect/wait", "stage/detect/fetch"),
])
def test_layer_spans_nest_where_the_work_happens(events, child, parent):
    outer = _spans(events, parent)
    inner = _spans(events, child)
    assert inner
    for s, e in inner:
        assert any(a <= s and e <= b for a, b in outer), (child, s, e)


def test_one_dispatch_wait_and_fusion_a_group(events):
    dispatch = _spans(events, "stage/detect/dispatch")
    wait = _spans(events, "stage/detect/wait")
    fusion = _spans(events, "stage/detect/fusion")
    assert len(dispatch) == len(wait) == len(fusion) == GROUPS
    # group k: its dispatch, then its wait, then its merges and fusion
    for (_, d_end), (w_start, w_end), (f_start, _) in zip(dispatch, wait,
                                                          fusion):
        assert d_end <= w_start and w_end <= f_start


def test_the_next_group_is_dispatched_before_the_wait(events):
    """One group of look-ahead: group k+1's dispatch ends before the host
    starts waiting for group k."""
    dispatch = _spans(events, "stage/detect/dispatch")
    wait = _spans(events, "stage/detect/wait")
    assert len(dispatch) == len(wait) == GROUPS
    for (_, d_end), (w_start, _) in zip(dispatch[1:], wait):
        assert d_end <= w_start


def test_the_input_cast_lies_outside_the_forward(events):
    """The tiles' cast to the compute dtype runs before the forward's span
    opens, so the span holds the network's kernels alone."""
    fwd = _spans(events, f"forward_{TS}")
    casts = [(s, e) for n, s, e, shape in events
             if n == "aten::_to_copy" and len(shape) == 4
             and list(shape[-2:]) == [TS, TS]]
    assert fwd and casts
    for s, e in casts:
        assert not any(a <= s and e <= b for a, b in fwd)


def test_no_profiler_makes_no_record_function(detector, monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        made.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    list(detector.detect_stream(_maps(2)))
    with prof.span("x"), prof.timed("y"):
        pass
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with prof.span("x"):
            pass
    assert made == [prof.SPAN_PREFIX + "x"]


def test_the_registry_keeps_a_count_and_a_total():
    prof.reset()
    try:
        for _ in range(3):
            with prof.timed("stage"):
                pass
        assert prof._STAGES == {"stage": [3, pytest.approx(
            prof.report()["stage"]["total_s"])]}
        rep = prof.report()["stage"]
        assert rep["calls"] == 3 and rep["total_s"] >= 0
        assert rep["mean_ms"] == pytest.approx(rep["total_s"] / 3 * 1e3)
    finally:
        prof.reset()
