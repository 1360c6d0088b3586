"""Detection rows of the port's bf16 default against the JAX package's bf16
on one synthetic 416x416 map, for the 4-channel slice (``detect_416_4ch``,
``train416_4ch.ckpt``) and the 3-channel 416 path (``detect_416``,
``train416.ckpt``), held to the gap between the JAX package's own bf16 and
float32 rows on that map. Rows with conf >= 0.35 are paired by class and
IoU >= 0.5; the low-confidence tail, where bf16 reorders candidates, is
not compared."""

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
from oriented_object_detection_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {"detect_416_4ch": ("train416_4ch.ckpt", 4),
         "detect_416": ("train416.ckpt", 3)}
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

CONF = 0.35        # rows compared
MARGIN = 0.05      # a row this close to CONF may lack a partner
IOU = 0.5


def pair_rows(a: np.ndarray, b: np.ndarray) -> tuple:
    """Greedy one-to-one pairs of [N, 11] rows with conf >= CONF - MARGIN,
    in ``a``'s conf order: same class, IoU >= IOU, the best IoU first.
    Returns (pairs [(i, j)], unpaired rows of a, unpaired rows of b); a pair
    counts if either row has conf >= CONF."""
    a = a[a[:, 9] >= CONF - MARGIN]
    b = b[b[:, 9] >= CONF - MARGIN]
    iou = native.quad_iou_matrix(np.ascontiguousarray(a[:, :8]),
                                 np.ascontiguousarray(b[:, :8])) \
        if len(a) and len(b) else np.zeros((len(a), len(b)))
    iou = np.where(a[:, 8:9] == b[None, :, 8], iou, 0.0)
    used, pairs = np.zeros(len(b), bool), []
    for i in np.argsort(-a[:, 9], kind="stable"):
        cand = np.where(~used & (iou[i] >= IOU), iou[i], -1.0)
        j = int(cand.argmax()) if len(b) else -1
        if j >= 0 and cand[j] >= IOU:
            used[j] = True
            pairs.append((int(i), j))
    paired_a = {i for i, _ in pairs}
    keep = [(i, j) for i, j in pairs if max(a[i, 9], b[j, 9]) >= CONF]
    lone_a = a[[i for i in range(len(a)) if i not in paired_a]]
    return a, b, keep, lone_a, b[~used]


def corner_distance(p: np.ndarray, q: np.ndarray) -> float:
    """Largest distance between corresponding corners, over the four
    cyclic orders of q's corners (a box's first corner may move)."""
    p, q = p[:8].reshape(4, 2), q[:8].reshape(4, 2)
    return min(float(np.linalg.norm(p - np.roll(q, k, axis=0), axis=1).max())
               for k in range(4))


def gap(a: np.ndarray, b: np.ndarray) -> tuple:
    """(largest corner distance, largest |dconf|) over the pairs of a and
    b, and the number of pairs; unpaired rows must lie within MARGIN of
    CONF."""
    a, b, pairs, lone_a, lone_b = pair_rows(a, b)
    for lone in (lone_a, lone_b):
        assert (lone[:, 9] < CONF + MARGIN).all(), lone[:, 8:10]
    dist = max((corner_distance(a[i], b[j]) for i, j in pairs), default=0.0)
    dconf = max((abs(a[i, 9] - b[j, 9]) for i, j in pairs), default=0.0)
    return dist, dconf, len(pairs)


@pytest.fixture(scope="module")
def image():
    return gen_map(np.random.RandomState(0), H=416, W=416, n_obj=30)[0]


@pytest.mark.parametrize("preset", sorted(CKPTS))
def test_bf16_rows_within_jax_own_gap(image, preset):
    """The port's bf16 rows pair with the JAX package's bf16 rows; the
    pairs' largest corner distance and |dconf| are at most 1.5 times the
    same between the JAX package's bf16 and float32 rows, or 0.5 px and
    0.01, whichever is larger."""
    name, ch = CKPTS[preset]
    ckpt = os.path.join(REPO, "assets", "bench_ckpts", name)
    det = P.build_detector([(416, 100, ckpt)], channels=ch, device="cpu")
    assert det.cfg.compute_dtype == "bfloat16"
    port = det.detect_image(image)["merged_for_pr"]
    jax_rows = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(
            JAX_PRESETS[preset], compute_dtype=dtype,
            max_det_per_map=1 << 20,
            scales=(JaxScale(416, 100, model_scale="n"),))
        jax_rows[dtype] = JaxDetector(cfg, {416: jax_variables(ckpt)}
                                      ).detect_image(image)["merged_for_pr"]
    own = gap(jax_rows["bfloat16"], jax_rows["float32"])
    got = gap(port, jax_rows["bfloat16"])
    print(f"{preset}: port-jax_bf16 {got[0]:.3f} px, dconf {got[1]:.4f} "
          f"({got[2]} pairs); jax bf16-f32 {own[0]:.3f} px, dconf "
          f"{own[1]:.4f} ({own[2]} pairs)")
    assert got[2] >= 10
    assert got[0] <= max(1.5 * own[0], 0.5)
    assert got[1] <= max(1.5 * own[1], 0.01)
