"""The frozen reference agrees with the program's float32 path (YOLO11n-OBB,
small maps, CPU): detection rows, the three training steps, and the host
merges against the program's native library."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tiny
from obbbench.harness import compare, detection, spec
from obbbench.reference import merge

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def float32_dir(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("f32")),
                     compute_dtype="float32")


def test_detection_matches_program_float32(float32_dir):
    cell = spec.load_cell("dual_single_maps", spec.ROOT, float32_dir)
    drv = cell.driver
    sess = drv.setup(cell, 2 ** 33 + 5, CPU)
    drv.window(sess, 0.0, 4)
    drv.release(sess)
    r = drv.readings(sess, None)
    assert r["strong_rows"] > 20
    assert r["unpaired_share"] == 0.0
    assert r["conf_gap_mean"] < 1e-5
    # and row for row above the floor, by scale and fused
    for (_, got), ref in zip([sess.results[i] for i in sess.sample],
                             sess.ref_f32):
        for ts, rows in ref["by_scale"].items():
            g = got["by_scale"][ts]
            g = g[g[:, 9] >= detection.FLOOR]
            assert len(g) == len(rows)
            key = lambda a: a[np.lexsort((a[:, 0], a[:, 9]))]
            np.testing.assert_allclose(key(g), key(rows), atol=2e-3)


def test_training_matches_program_float32(float32_dir):
    cell = spec.load_cell("train416_b16", spec.ROOT, float32_dir)
    drv = cell.driver
    sess = drv.setup(cell, 77, CPU)
    drv.release(sess)
    r = drv.readings(sess, None)
    for k in ("loss_gap", "grad_gap", "change_gap", "ema_gap"):
        assert r[k] < 1e-3, (k, r)


def _boxes(rng, n):
    c = rng.uniform(0, 200, (n, 2))
    w, h, t = rng.uniform(5, 30, n), rng.uniform(4, 20, n), rng.uniform(
        -np.pi, np.pi, n)
    co, si = np.cos(t), np.sin(t)
    rows = np.zeros((n, 11))
    for k, (su, sv) in enumerate(((1, 1), (1, -1), (-1, -1), (-1, 1))):
        rows[:, 2 * k] = c[:, 0] + su * w / 2 * co - sv * h / 2 * si
        rows[:, 2 * k + 1] = c[:, 1] + su * w / 2 * si + sv * h / 2 * co
    rows[:, 8] = rng.integers(0, 3, n)
    rows[:, 9] = rng.uniform(0.2, 1.0, n)
    return rows


def test_merges_match_the_native_library():
    from oriented_object_detection_tpu_torch.infer import fusion as F
    from oriented_object_detection_tpu_torch.utils import native

    rng = np.random.default_rng(3)
    a, b = _boxes(rng, 300), _boxes(rng, 250)
    for i in range(40):
        for j in range(40):
            assert merge.quad_iou(a[i], b[j]) == pytest.approx(
                native.quad_iou_matrix(a[i:i + 1, :8], b[j:j + 1, :8])[0, 0],
                abs=1e-12)
    np.testing.assert_array_equal(merge.greedy_merge(a, 0.4),
                                  F.merge_detections(a, 0.4))
    by_scale = {128: a, 416: b}
    np.testing.assert_array_equal(
        merge.consensus(by_scale), F.cross_scale_consensus_filter(by_scale))


def test_pairing_counts_a_moved_row():
    rows = _boxes(np.random.default_rng(5), 50)
    rows[:, 9] = 0.9
    p = compare.pair_rows(rows, rows)
    assert p["unpaired"] == 0 and p["strong"] == 100
    moved = rows.copy()
    moved[0, 0:8:2] += 40.0
    p = compare.pair_rows(moved, rows)
    assert p["unpaired"] == 2
