"""YOLO11-OBB (``ultralytics/cfg/models/11/yolo11-obb.yaml``): the port's
``TiledDetector`` built from the configuration's checkpoints, the frozen
reference model loaded from the same files (``reference/detect.py``,
which imports nothing of the program), and the reference's FLOPs of
one tile."""

from __future__ import annotations

import os

from obbbench.harness import flops as FL
from obbbench.reference import detect as RD


def program_detector(cell, device):
    """The program's ``TiledDetector`` for the configuration, every knob
    the configuration states passed through."""
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)

    cfg = cell.config
    triples = [(s["tile_size"], s["overlap"],
                os.path.join(cell.root, s["checkpoint"]))
               for s in cfg["scales"]]
    fields = {k: cfg[k] for k in (
        "calculate_metrics", "conf_thr_metrics", "conf_thr_predict",
        "engine_nms_iou", "merge_iou", "apply_border_filter", "margin_128",
        "margin_416", "max_det_per_tile", "pre_topk", "compute_dtype")}
    return build_detector(triples, channels=cfg["channels"],
                          model_scale=cfg["model_scale"], device=device,
                          **fields)


def reference_models(cfg: dict, root: str, device,
                     precision: str = "float32") -> dict:
    """{tile_size: reference model in eval mode} of a configuration's
    scales, each from its checkpoint file."""
    return RD.load_models(cfg, root, device, precision)


def forward_flops(cfg: dict, tile: int) -> float:
    """FLOPs of one forward of one ``tile`` x ``tile`` input."""
    return FL.forward_flops(cfg["model_scale"], tile, cfg["nc"],
                            cfg["channels"])
