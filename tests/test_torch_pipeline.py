"""The port's 4-channel 416/100 slice (infer/pipeline.py) against the JAX
package's ``TiledDetector`` in float32 on a 740x740 synthetic map (4 tiles)
with the committed ``train416_4ch.ckpt``, the port's CLI, the checkpoint
checks of ``read_scales`` and the host merge."""

import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest

from oriented_object_detection_tpu.config import PRESETS as JAX_PRESETS
from oriented_object_detection_tpu.config import ScaleConfig as JaxScale
from oriented_object_detection_tpu.infer.pipeline import (
    TiledDetector as JaxDetector)
from oriented_object_detection_tpu.train.trainer import (
    variables_from_checkpoint as jax_variables)
from oriented_object_detection_tpu.utils import native as jax_native
from oriented_object_detection_tpu.utils.xlsx import read_xlsx
from oriented_object_detection_tpu_torch import cli
from oriented_object_detection_tpu_torch.config import (CLASS_NAMES,
                                                        PRESETS, ScaleConfig)
from oriented_object_detection_tpu_torch.infer import pipeline as P
from oriented_object_detection_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train416_4ch.ckpt")
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import match_one_to_one, port_float32  # noqa: E402

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def image():
    return gen_map(np.random.RandomState(0), H=740, W=740, n_obj=30)[0]


@pytest.fixture(scope="module")
def detector():
    return P.build_detector([(416, 100, CKPT)], channels=4, device="cpu",
                            compute_dtype="float32")


@pytest.fixture(scope="module")
def results(image, detector):
    cfg = dataclasses.replace(
        JAX_PRESETS["detect_416_4ch"],
        scales=(JaxScale(416, 100, model_scale="n"),),
        compute_dtype="float32")
    ref = JaxDetector(cfg, {416: jax_variables(CKPT)}).detect_image(image)
    return ref, detector.detect_image(image)


def test_slice_rows_match_jax(results):
    ref, got = results
    rows = got["merged_for_pr"]
    assert len(rows) >= 10
    assert (rows[:, 9] >= PRESETS["detect_416_4ch"].conf_thr_predict).all()
    match_one_to_one(rows, ref["merged_for_pr"])


def test_per_scale_rows_match_jax(results):
    ref, got = results
    match_one_to_one(got["by_scale"][416], ref["by_scale"][416])


def test_rows_inside_map_and_strike_angles(results, image):
    rows = results[1]["merged_for_pr"]
    cx, cy = rows[:, 0:8:2].mean(1), rows[:, 1:8:2].mean(1)
    assert ((cx >= 0) & (cx <= image.shape[1]) & (cy >= 0)
            & (cy <= image.shape[0])).all()
    assert (rows[rows[:, 8] != P.STRIKE_CLS, 10] == 0).all()
    assert ((rows[:, 10] >= 0) & (rows[:, 10] <= 180)).all()


def test_predict_accessors(detector, image, results):
    rows = results[1]["merged_for_pr"]
    det = P.Detections(rows)
    assert len(det) == len(rows)
    np.testing.assert_array_equal(det.xyxyxyxy.reshape(-1, 8), rows[:, :8])
    np.testing.assert_array_equal(det.cls, rows[:, 8].astype(np.int64))
    np.testing.assert_array_equal(det.conf, rows[:, 9])
    np.testing.assert_array_equal(det.angle, rows[:, 10])
    assert det.names == CLASS_NAMES


def test_cli_detect_writes_the_detector_rows(tmp_path, image, results):
    inp, out = tmp_path / "in", tmp_path / "out"
    inp.mkdir()
    cv2.imwrite(str(inp / "map0.png"), image)
    with port_float32():
        cli.main(["detect", "--input", str(inp), "--output", str(out),
                  "--ckpt416", CKPT, "--channels", "4", "--device", "cpu"])
    sheet = read_xlsx(str(out / "map0.xlsx"))
    rows = results[1]["merged_for_pr"]
    assert sheet[0] == ["Class", "X1", "Y1", "X2", "Y2", "X3", "Y3", "X4",
                        "Y4", "Confidence", "Angle"]
    assert len(sheet) == len(rows) + 1
    for cells, r in zip(sheet[1:], rows):
        assert cells[0] == CLASS_NAMES[int(r[8])]
        np.testing.assert_array_equal(
            np.asarray(cells[1:], np.float64),
            np.concatenate([r[:8], r[9:11]]))


def test_cli_refuses_channel_mismatch(tmp_path):
    """A 3-channel checkpoint under ``--channels 4`` is refused with the JAX
    package's message."""
    with pytest.raises(SystemExit,
                       match="trained with channels=3 but --channels 4"):
        cli.main(["detect", "--input", str(tmp_path), "--output",
                  str(tmp_path / "o"), "--ckpt416",
                  os.path.join(REPO, "assets", "bench_ckpts", "train416.ckpt"),
                  "--channels", "4", "--device", "cpu"])


@pytest.mark.parametrize("extra, sizes, expect", [
    ({"channels": 3, "model_scale": "n"}, (416,),
     "trained with channels=3 but --channels 4"),
    ({"channels": 4, "model_scale": "n"}, (416, 416),
     "duplicate tile size 416"),
    ({"tile_size": 416, "model_scale": "n"}, (416,), "n"),
    ({"channels": 4, "tile_size": 416, "model_scale": "x"}, (416,), "x"),
], ids=["channels_mismatch", "duplicate_tile_size", "no_channels_recorded",
        "x_scale_recorded"])
def test_detector_refuses_unported_checkpoints(tmp_path, extra, sizes,
                                               expect):
    """What ``read_scales`` reads from a checkpoint's ``extra`` under
    ``--channels 4 --scale n``: a recorded channels count that differs, or
    a tile size given twice, is refused; a checkpoint that records no
    channels count runs with the one asked for; a recorded model scale
    wins over the one asked for."""
    path = tmp_path / "model.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"params": {}, "batch_stats": {}, "extra": extra}, f)
    triples = [(ts, 100, str(path)) for ts in sizes]
    if len(expect) > 1:
        with pytest.raises(ValueError, match=expect):
            P.read_scales(triples, channels=4, model_scale="n")
        return
    scales, params = P.read_scales(triples, channels=4, model_scale="n")
    assert scales == (ScaleConfig(416, 100, checkpoint=str(path),
                                  model_scale=expect),)
    assert list(params) == [416]


def test_dual_scale_is_refused():
    """Scales are keyed by tile size: two scales of one tile size are
    refused."""
    cfg = dataclasses.replace(PRESETS["detect_416_4ch"],
                              scales=(ScaleConfig(416, 30),
                                      ScaleConfig(416, 100)))
    with pytest.raises(ValueError, match="duplicate tile sizes"):
        P.TiledDetector(cfg, {}, device="cpu")


def _random_dets(n, seed):
    rng = np.random.RandomState(seed)
    cx, cy = rng.uniform(0, 200, n), rng.uniform(0, 200, n)
    w, h = rng.uniform(5, 40, n), rng.uniform(5, 30, n)
    t = rng.uniform(0, 3, n)
    pts = []
    for sx, sy in ((1, 1), (1, -1), (-1, -1), (-1, 1)):
        pts += [cx + sx * w / 2 * np.cos(t) - sy * h / 2 * np.sin(t),
                cy + sx * w / 2 * np.sin(t) + sy * h / 2 * np.cos(t)]
    d = np.zeros((n, 11))
    d[:, :8] = np.stack(pts, -1)
    d[:, 8] = rng.randint(0, 3, n)
    d[:, 9] = np.round(rng.uniform(0.2, 1.0, n), 2)   # ties included
    return d


def test_native_merges_equal_jax_package(detector):
    d = _random_dets(300, 5)
    np.testing.assert_array_equal(native.greedy_nms_grid(d, 0.4)[0],
                                  jax_native.greedy_nms(d, 0.4))
    groups = np.sort(np.random.RandomState(6).randint(0, 9, len(d)))
    np.testing.assert_array_equal(
        native.greedy_nms_grouped(d, groups, 0.4),
        jax_native.greedy_nms_grouped(d, groups, 0.4))
    with pytest.raises(ValueError):
        native.greedy_nms_grouped(d, groups[:-1], 0.4)


def test_native_library_builds_outside_native_dir():
    lib_path = native.load()._name
    assert os.path.dirname(lib_path).endswith(
        os.path.join("oriented_object_detection_tpu_torch", "_build"))
