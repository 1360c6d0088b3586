"""The port's CLI (``cli.py detect``) on one seeded 400x400 map with its
label file, dual scale with the committed YOLO11n-OBB checkpoints:
``{stem}_detected.jpg`` (the JAX package's drawing of the same rows),
``{stem}.xlsx``, the fused rows against the JAX detector's, and the
``--metrics`` block against the JAX package's block on the same map; and
that without ``--device cpu`` it wants the card."""

import dataclasses
import os
import re
import sys

import numpy as np
import pytest
import torch

from oriented_object_detection_tpu.config import PRESETS as JAX_PRESETS
from oriented_object_detection_tpu.config import ScaleConfig as JaxScale
from oriented_object_detection_tpu.data import labels as JL
from oriented_object_detection_tpu.eval import metrics as JM
from oriented_object_detection_tpu.infer.pipeline import (
    TiledDetector as JaxDetector)
from oriented_object_detection_tpu.infer.pipeline import (
    draw_detections as jax_draw)
from oriented_object_detection_tpu.train.trainer import (
    variables_from_checkpoint as jax_variables)
from oriented_object_detection_tpu.utils.xlsx import read_xlsx
from oriented_object_detection_tpu_torch import cli
from oriented_object_detection_tpu_torch.config import CLASS_NAMES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {ts: os.path.join(REPO, "assets", "bench_ckpts", f"train{ts}.ckpt")
         for ts in (128, 416)}
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import match_one_to_one, port_float32  # noqa: E402

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def mapdir(tmp_path_factory):
    """A folder with one seeded 400x400 map and its label file."""
    img, lab = gen_map(np.random.RandomState(1), H=400, W=400, n_obj=20)
    d = tmp_path_factory.mktemp("input")
    cv2.imwrite(str(d / "map0.png"), img)
    JL.write_labels(str(d / "map0.txt"), lab)
    return d, img


BLOCK = (("precision", r"Precision=([\d.]+)"), ("recall", r"Recall=([\d.]+)"),
         ("f1", r"\| F1=([\d.]+)"), ("mAP@0.5", r"mAP@0\.5 = ([\d.]+)"),
         ("mAP@[0.5:0.95]", r"mAP@\[0\.5:0\.95\] = ([\d.]+)"),
         ("soft_mAP@0.3", r"mAP@0\.3 = ([\d.]+)"),
         ("soft_mAP@[0.3:0.7]", r"mAP@\[0\.3:0\.7\] = ([\d.]+)"))


def test_cli_dual_n_scale_writes_jpg_xlsx_and_metrics(mapdir, tmp_path,
                                                      capsys):
    inp, img = mapdir
    out = tmp_path / "out"
    with port_float32():
        cli.main(["detect", "--input", str(inp), "--output", str(out),
                  "--ckpt128", CKPTS[128], "--ckpt416", CKPTS[416],
                  "--scale", "n", "--metrics", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert re.search(r"--- \d+\.\d{3} seconds ---", printed)

    sheet = read_xlsx(str(out / "map0.xlsx"))
    assert sheet[0][0] == "Class" and len(sheet) > 5
    rows = np.array([r[1:9] + [0.0] + r[9:] for r in sheet[1:]], np.float64)
    rows[:, 8] = [next(k for k, v in CLASS_NAMES.items() if v == r[0])
                  for r in sheet[1:]]
    np.testing.assert_array_equal(
        cv2.imread(str(out / "map0_detected.jpg")),
        _jpg_roundtrip(jax_draw(img, rows), tmp_path))
    assert read_xlsx(str(out / "fusion_classwise_metrics.xlsx"))[0] == [
        "cls_id", "class", "TP", "FP", "FN", "Precision", "Recall", "F1"]

    cfg = dataclasses.replace(
        JAX_PRESETS["detect_dual"], compute_dtype="float32",
        max_det_per_map=1 << 20,
        scales=tuple(JaxScale(ts, ov, model_scale="n")
                     for ts, ov in ((128, 30), (416, 100))))
    jd = JaxDetector(cfg, {ts: jax_variables(CKPTS[ts]) for ts in CKPTS})
    res = jd.detect_image(img)
    match_one_to_one(rows, res["merged_for_pr"])
    path = str(inp / "map0.png")
    ref = JM.run_fusion_eval({path: res["merged_for_pr"]}, str(inp),
                             str(tmp_path), dets_map={
                                 path: res["merged_for_map"]})
    capsys.readouterr()
    assert "[Fusion] scale-agnostic merge" in printed
    for key, pattern in BLOCK:
        got = float(re.search(pattern, printed).group(1))
        assert abs(got - ref[key]) <= 0.01, (key, got, ref[key])
    assert ref["mAP@0.5"] > 0.3


def _jpg_roundtrip(image, tmp_path):
    cv2.imwrite(str(tmp_path / "ref.jpg"), image)
    return cv2.imread(str(tmp_path / "ref.jpg"))


def test_cli_without_card_raises(mapdir, tmp_path, monkeypatch):
    """Without ``--device cpu`` the CLI wants the card and never runs on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["detect", "--input", str(mapdir[0]), "--output",
                  str(tmp_path), "--ckpt416", CKPTS[416]])
    assert not any(tmp_path.iterdir())
