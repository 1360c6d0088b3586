"""The port's single-crop predictor (``TiledDetector.predict_crop``) with
the committed YOLO11n-OBB checkpoints, 4 channels (DT-Edge at the crop's
own shape) and 3, against the JAX package's ``predict_crop`` on a 300x260
crop of a synthetic map (letterboxed up to 416) and, for 4 channels, a
500x700 one (letterboxed down)."""

import dataclasses
import os
import sys

import numpy as np
import pytest

from oriented_object_detection_tpu.config import PRESETS as JAX_PRESETS
from oriented_object_detection_tpu.config import ScaleConfig as JaxScale
from oriented_object_detection_tpu.infer.pipeline import (
    TiledDetector as JaxDetector)
from oriented_object_detection_tpu.train.trainer import (
    variables_from_checkpoint as jax_variables)
from oriented_object_detection_tpu_torch.infer import pipeline as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {c: os.path.join(REPO, "assets", "bench_ckpts", name)
         for c, name in ((4, "train416_4ch.ckpt"), (3, "train416.ckpt"))}
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import match_one_to_one, one_torch_thread  # noqa: E402,F401

pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def image():
    return gen_map(np.random.RandomState(21), H=560, W=760, n_obj=30)[0]


@pytest.mark.parametrize("channels, size", [(4, (300, 260)),
                                            (3, (300, 260)),
                                            (4, (500, 700))],
                         ids=["4ch_up", "3ch_up", "4ch_down"])
def test_predict_crop_matches_jax(image, channels, size):
    h, w = size
    crop = np.ascontiguousarray(image[30:30 + h, 40:40 + w])
    det = P.build_detector([(416, 100, CKPTS[channels])], channels=channels,
                           device="cpu", compute_dtype="float32")
    got = det.predict_crop(crop)
    cfg = dataclasses.replace(
        JAX_PRESETS["detect_416_4ch" if channels == 4 else "detect_416"],
        compute_dtype="float32",
        scales=(JaxScale(416, 100, model_scale="n"),))
    ref = JaxDetector(cfg, {416: jax_variables(CKPTS[channels])}
                      ).predict_crop(crop)
    assert isinstance(got, P.Detections) and got.rows.shape[1] == 11
    assert len(got) >= 3
    match_one_to_one(got.rows, ref.rows)
    # crop coordinates: centres inside the crop, conf above the threshold
    cx, cy = got.rows[:, 0:8:2].mean(1), got.rows[:, 1:8:2].mean(1)
    assert ((cx >= 0) & (cx <= w) & (cy >= 0) & (cy <= h)).all()
    assert (got.conf >= det.cfg.conf_thr_predict).all()
    with pytest.raises(ValueError, match="no model for tile size 128"):
        det.predict_crop(crop, tile_size=128)
