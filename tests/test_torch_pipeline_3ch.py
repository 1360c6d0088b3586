"""The port's 3-channel presets ``detect_416`` and ``detect_128`` with the
committed YOLO11n-OBB checkpoints against the JAX package in float32 on one
seeded 400x400 map. The CLI on that map is in ``test_torch_cli.py``."""

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
from oriented_object_detection_tpu_torch.config import PRESETS
from oriented_object_detection_tpu_torch.infer import pipeline as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {ts: os.path.join(REPO, "assets", "bench_ckpts", f"train{ts}.ckpt")
         for ts in (128, 416)}
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import match_one_to_one  # noqa: E402

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def image():
    return gen_map(np.random.RandomState(1), H=400, W=400, n_obj=20)[0]


@pytest.mark.parametrize("preset", ["detect_416", "detect_128"])
def test_single_scale_3ch_rows_match_jax(image, preset):
    sc = PRESETS[preset].scales[0]
    det = P.build_detector([(sc.tile_size, sc.overlap,
                             CKPTS[sc.tile_size])], device="cpu",
                           compute_dtype="float32")
    assert det.cfg.channels == 3 and det.cfg.scales[0].model_scale == "n"
    assert det.cfg.scales == (dataclasses.replace(
        sc, checkpoint=CKPTS[sc.tile_size], model_scale="n"),)
    got = det.detect_image(image)
    cfg = dataclasses.replace(
        JAX_PRESETS[preset], compute_dtype="float32",
        scales=(JaxScale(sc.tile_size, sc.overlap, model_scale="n"),))
    ref = JaxDetector(cfg, {sc.tile_size: jax_variables(
        CKPTS[sc.tile_size])}).detect_image(image)
    assert list(got["by_scale"]) == [sc.tile_size]
    assert len(got["merged_for_pr"]) >= 5
    match_one_to_one(got["by_scale"][sc.tile_size],
                      ref["by_scale"][sc.tile_size])
    match_one_to_one(got["merged_for_pr"], ref["merged_for_pr"])
    dets = det.predict(image)
    assert [len(d) for d in dets] == [1] * len(dets)
    np.testing.assert_array_equal(
        np.concatenate([d.rows for d in dets]), got["merged_for_pr"])
