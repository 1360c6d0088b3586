"""Each metric module gives the expected number on a canned record of
spans and kernels (per-layer) or of a window (end to end)."""

from __future__ import annotations

import pytest

import tiny
from obbbench.harness import flops as FL
from obbbench.harness import spec
from obbbench.harness import trace as TR


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """The cell of a name, held-back cells too, at its own size."""
    full = tiny.make(str(tmp_path_factory.mktemp("full")), small=False)
    return lambda name: spec.load_cell(name, spec.ROOT, full)

K = TR.Kernel


def canned_detect_trace() -> TR.Trace:
    """A 1.0 s window: spans of a dispatch holding two forwards, a decode
    and an NMS, then a merge; kernels launched in each."""
    spans = [("obb/window", 0.0, 1.0),
             ("obb/stage/detect/dispatch", 0.00, 0.30),
             ("obb/forward_128", 0.01, 0.10),
             ("obb/decode_raw", 0.10, 0.12),
             ("obb/postprocess_batch", 0.12, 0.15),
             ("obb/forward_416", 0.15, 0.25),
             ("obb/stage/detect/merge_128", 0.40, 0.50)]
    kernels = [K("sm90_xmma_fprop_bf16", 0.05, 0.35, "obb/forward_128"),
               K("elementwise_add", 0.35, 0.40, "obb/forward_128"),
               K("softmax", 0.40, 0.42, "obb/decode_raw"),
               K("radixSort", 0.42, 0.46, "obb/postprocess_batch"),
               K("cudnn_conv", 0.46, 0.77, "obb/forward_416"),
               K("Memcpy DtoH", 0.77, 0.80, "obb/stage/detect/dispatch")]
    return TR.Trace(kernels=kernels, spans=spans, window=(0.0, 1.0),
                    stages={"detect/dispatch": 0.3, "detect/merge_128": 0.1,
                            "detect/merge_416": 0.05, "detect/fusion": 0.05,
                            "detect/fetch": 0.2}, units=2)


def test_busy_idle_and_breakdown():
    tr = canned_detect_trace()
    assert tr.busy_s == pytest.approx(0.75)
    assert tr.kernel_seconds("obb/forward_") == pytest.approx(0.66)
    assert tr.kernel_seconds("", kind="conv_matmul") == pytest.approx(0.61)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["cudnn_conv", pytest.approx(0.31)]
    gaps = dict(b["idle_gaps"])
    # 0.00-0.05 begins in the dispatch, 0.80-1.00 outside every span
    assert gaps["obb/stage/detect/dispatch"] == pytest.approx(0.05)
    assert gaps["outside any span"] == pytest.approx(0.20)


def test_host_span_is_innermost():
    tr = canned_detect_trace()
    assert tr.host_span_at(0.05) == "obb/forward_128"
    assert tr.host_span_at(0.2) == "obb/forward_416"
    assert tr.host_span_at(0.28) == "obb/stage/detect/dispatch"
    assert tr.host_span_at(0.6) == ""


def test_detect_folder_readers(cell):
    c = cell("dual_folder_sheets")
    tr = canned_detect_trace()
    rec = {"mpix": [16.777216, 16.777216], "flops": 2 * 28.8e12, "units": 2}
    read = {m["name"]: c.module("layer_metrics", m["name"]).value(
        tr, rec, c) for m in c.per_layer}
    mpix = 2 * 16.777216
    assert read["decode_nms_ms.detect_folder"] == pytest.approx(60 / mpix)
    assert read["host_merge_ms.detect_folder"] == pytest.approx(200 / mpix)
    assert read["idle_share.detect_folder"] == pytest.approx(25.0)
    assert read["mfu.detect_folder"] == pytest.approx(
        100 * 57.6e12 / 1.0 / FL.PEAK_FLOPS["bfloat16"])
    assert read["forward_roofline.detect_folder"] == pytest.approx(
        100 * 57.6e12 / FL.PEAK_FLOPS["bfloat16"] / 0.66)


def test_detect_single_readers(cell):
    c = cell("dual_single_maps")
    tr = canned_detect_trace()
    rec = {"mpix": [0.72, 1.09], "flops": 3e12, "units": 2}
    read = {m["name"]: c.module("layer_metrics", m["name"]).value(
        tr, rec, c) for m in c.per_layer}
    assert read["dispatch_ms.detect_single"] == pytest.approx(150.0)
    assert read["idle_share.detect_single"] == pytest.approx(25.0)
    assert read["mfu.detect_single"] == pytest.approx(
        100 * 3e12 / FL.PEAK_FLOPS["bfloat16"])


def test_train_readers(cell):
    c = cell("train416_b16")
    spans = [("obb/window", 0.0, 0.5), ("obb/loader", 0.0, 0.02),
             ("obb/train_step", 0.02, 0.25), ("obb/loader", 0.25, 0.27),
             ("obb/train_step", 0.27, 0.5)]
    kernels = [K("sm90_xmma_wgrad", 0.03, 0.10, "obb/train_step"),
               K("vectorized_elementwise_kernel", 0.10, 0.20,
                 "obb/train_step"),
               K("reduce_kernel", 0.28, 0.33, "obb/train_step"),
               K("Memcpy HtoD", 0.26, 0.265, "obb/loader")]
    tr = TR.Trace(kernels=kernels, spans=spans, window=(0.0, 0.5), units=2)
    rec = {"steps": 2, "loader_s": [0.02, 0.02], "flops": 2 * 4.1e12,
           "units": 2}
    read = {m["name"]: c.module("layer_metrics", m["name"]).value(
        tr, rec, c) for m in c.per_layer}
    assert read["loader_ms.train"] == pytest.approx(20.0)
    assert read["elementwise_ms.train"] == pytest.approx(75.0)
    assert read["idle_share.train"] == pytest.approx(
        100 * (1 - 0.225 / 0.5))
    assert read["mfu.train"] == pytest.approx(
        100 * 8.2e12 / 0.5 / FL.PEAK_FLOPS["bfloat16"])


def test_readers_find_nothing_and_return_nothing(cell):
    empty = TR.Trace(window=(0.0, 1.0))
    for name in ("dual_folder_sheets", "dual_single_maps", "train416_b16"):
        c = cell(name)
        for m in c.per_layer:
            v = c.module("layer_metrics", m["name"]).value(
                empty, {"units": 0, "mpix": [], "steps": 0, "loader_s": [],
                        "flops": 0}, c)
            assert v is None, m["name"]


def test_end_to_end_metrics(cell):
    c = cell("dual_single_maps")
    rec = {"window_s": 2.0, "units": 4, "mpix": [1.0, 1.0, 1.0, 1.0],
           "latency_s": [float(i) for i in range(1, 21)],
           "peak_bytes": 2 ** 31, "setup_s": 30.0}
    read = {m["name"]: c.module("end_to_end", m["name"]).value(rec, c)
            for m in c.end_to_end}
    assert read == {"detect_mpix_per_s": 2.0,
                    "detect_map_p95_s": pytest.approx(19.05),
                    "peak_mem_gib": 2.0, "setup_s": 30.0}
    t = cell("train416_b16")
    rec = {"window_s": 3.0, "units": 12, "steps": 12, "peak_bytes": 2 ** 30,
           "setup_s": 5.0}
    read = {m["name"]: t.module("end_to_end", m["name"]).value(rec, t)
            for m in t.end_to_end}
    assert read == {"train_step_s": 0.25, "peak_mem_gib": 1.0,
                    "setup_s": 5.0}


def test_flops_of_the_frozen_model():
    # Ultralytics gives 520.2 GFLOPs for YOLO11x-OBB at 1024
    assert FL.forward_flops("x", 1024) == pytest.approx(520.2e9, rel=0.01)
    assert FL.train_step_flops("x", 416, 16) == pytest.approx(
        48 * FL.forward_flops("x", 416))
