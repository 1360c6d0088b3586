"""The port's dual-scale detect path (``detect_dual``: 128/30 and 416/100,
3 channels, consensus fusion) on the committed int8 YOLO11x-OBB
checkpoints, against the JAX package in float32: the rows of a seeded
512x512 map in predict and in metrics mode. The checkpoints' dequant and
the x-scale forward are in ``test_torch_x_scale.py``, so that each file
stays short on one test worker."""

import dataclasses
import os
import sys

import numpy as np
import pytest

from oriented_object_detection_tpu.config import PRESETS as JAX_PRESETS
from oriented_object_detection_tpu.infer.pipeline import (
    TiledDetector as JaxDetector)
from oriented_object_detection_tpu.train.trainer import (
    variables_from_checkpoint as jax_variables)
from oriented_object_detection_tpu_torch.config import PRESETS
from oriented_object_detection_tpu_torch.infer import fusion as F
from oriented_object_detection_tpu_torch.infer import pipeline as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {ts: os.path.join(REPO, "assets", "bench_ckpts", f"train{ts}_x.ckpt")
         for ts in (128, 416)}
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import match_one_to_one  # noqa: E402

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def image():
    return gen_map(np.random.RandomState(0), H=512, W=512, n_obj=24)[0]


@pytest.fixture(scope="module")
def results(image):
    """The port's rows in predict and in metrics mode (one detector: the
    mode is read from ``cfg`` at call time) and the JAX package's in
    metrics mode, with ``max_det_per_map`` raised so that its per-map
    compaction, which the port does not copy, drops nothing.

    The JAX predict-mode rows are those metrics-mode rows with conf >=
    ``conf_thr_predict``, exactly: the engine NMS suppresses a box only by
    higher-conf candidates, and the per-tile merge and the consensus
    filter (which drops every row below CONS_LOW = ``conf_thr_predict``)
    are greedy in conf order, so rows below the threshold change no
    decision about rows above it. That saves a second x-scale run of
    the JAX detector."""
    det = P.build_detector(
        [(ts, ov, CKPTS[ts]) for ts, ov in ((128, 30), (416, 100))],
        device="cpu")
    port = {}
    for m in (False, True):
        det.cfg = dataclasses.replace(det.cfg, calculate_metrics=m)
        port[m] = det.detect_image(image)
    jcfg = dataclasses.replace(JAX_PRESETS["detect_dual"],
                               compute_dtype="float32",
                               max_det_per_map=1 << 20)
    ref = {True: JaxDetector(jcfg, {ts: jax_variables(CKPTS[ts])
                                    for ts in CKPTS}).detect_image(image)}
    thr = jcfg.conf_thr_predict
    ref[False] = {
        "by_scale": {ts: r[r[:, 9] >= thr]
                     for ts, r in ref[True]["by_scale"].items()},
        "merged_for_pr": ref[True]["merged_for_pr"]}
    return port, ref


@pytest.mark.parametrize("metrics", [False, True],
                         ids=["predict", "metrics"])
def test_by_scale_rows_match_jax(results, metrics):
    port, ref = results[0][metrics], results[1][metrics]
    assert sorted(port["by_scale"]) == [128, 416]
    for ts in (128, 416):
        rows = port["by_scale"][ts]
        assert len(rows) >= 10
        match_one_to_one(rows, ref["by_scale"][ts])


@pytest.mark.parametrize("metrics", [False, True],
                         ids=["predict", "metrics"])
def test_fused_rows_match_jax(results, metrics):
    port, ref = results[0][metrics], results[1][metrics]
    assert len(port["merged_for_pr"]) >= 10
    match_one_to_one(port["merged_for_pr"], ref["merged_for_pr"],
                      skip_near=(F.CONS_LOW, F.CONS_HIGH))
    assert ("merged_for_map" in port) == metrics
    if metrics:
        assert (port["merged_for_map"][:, 9] < 0.25).any()
        match_one_to_one(port["merged_for_map"], ref["merged_for_map"])


def test_dual_preset_is_the_default_path():
    cfg = PRESETS["detect_dual"]
    assert [(s.tile_size, s.overlap) for s in cfg.scales] == [(128, 30),
                                                              (416, 100)]
    assert cfg.channels == 3 and cfg.calculate_metrics
    assert (cfg.conf_thr_metrics, cfg.metrics_iou, cfg.map_min_score) == (
        0.001, 0.25, 0.001)
