"""``detect_stream``'s order on the CPU: a YOLO11n-OBB detector at tile
128 in bf16. Group k+1 is dispatched before group k is fetched (one group
of look-ahead), ``STREAM`` counts the groups and those queued ahead, and a
stream closed after its first result leaves the detector whole."""

import os

import numpy as np
import pytest

from oriented_object_detection_tpu_torch.infer import pipeline as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")


@pytest.fixture(scope="module")
def detector():
    return P.build_detector([(128, 30, CKPT)], channels=3, model_scale="n",
                            device="cpu", compute_dtype="bfloat16")


def _maps(n: int) -> list:
    rng = np.random.RandomState(9)
    return [rng.randint(0, 256, (140 + 10 * i, 160, 3), np.uint8)
            for i in range(n)]


def _assert_rows_equal(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in set(w) - {"by_scale"}:
            np.testing.assert_array_equal(g[key], w[key])
        assert sorted(g["by_scale"]) == sorted(w["by_scale"])
        for ts in w["by_scale"]:
            np.testing.assert_array_equal(g["by_scale"][ts],
                                          w["by_scale"][ts])


@pytest.mark.parametrize("chunk", [1, 2])
def test_group_k_plus_1_is_dispatched_before_group_k_is_fetched(
        detector, monkeypatch, chunk):
    calls, dispatched = [], []
    dispatch, fetch = detector._dispatch, detector._fetch

    def spy_dispatch(uploaded):
        pending = dispatch(uploaded)
        calls.append(f"D{len(dispatched)}")
        dispatched.append(pending)
        return pending

    def spy_fetch(pending):
        calls.append(f"F{[p is pending for p in dispatched].index(True)}")
        return fetch(pending)

    monkeypatch.setattr(detector, "_dispatch", spy_dispatch)
    monkeypatch.setattr(detector, "_fetch", spy_fetch)
    maps = _maps(3 * chunk)
    before = dict(P.STREAM)
    results = list(detector.detect_stream(maps, chunk=chunk))
    assert calls == ["D0", "D1", "F0", "D2", "F1", "F2"]
    assert {k: P.STREAM[k] - before[k] for k in P.STREAM} == {
        "groups": 3, "ahead": 2}
    monkeypatch.undo()
    want = [r for k in range(0, len(maps), chunk)
            for r in detector.detect_images(maps[k:k + chunk])]
    _assert_rows_equal(results, want)


def test_one_group_is_none_ahead(detector):
    before = dict(P.STREAM)
    assert len(list(detector.detect_stream(_maps(2), chunk=2))) == 2
    assert {k: P.STREAM[k] - before[k] for k in P.STREAM} == {
        "groups": 1, "ahead": 0}


def test_a_stream_closed_after_its_first_result_leaves_nothing_broken(
        detector):
    maps = _maps(4)
    stream = detector.detect_stream(maps, chunk=1)
    first = next(stream)
    stream.close()
    _assert_rows_equal([first], detector.detect_images(maps[:1]))
    _assert_rows_equal(list(detector.detect_stream(maps[1:], chunk=1)),
                       [detector.detect_images([m])[0] for m in maps[1:]])
