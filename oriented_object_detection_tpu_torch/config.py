"""Typed configuration for the port: the DT-Edge, scale and detection knobs
and the detection presets, copied from the JAX package's ``config.py`` so
that the port reads no module of it."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

# 12-entry class map (`Detect_OBB.py:44-57`).
CLASS_NAMES = {
    0: "Landslide 1",
    1: "Strike",
    2: "Spring 1",
    3: "Minepit 1",
    4: "Hillside",
    5: "Feuchte",
    6: "Torf",
    7: "Bergsturz",
    8: "Landslide 2",
    9: "Spring 2",
    10: "Spring 3",
    11: "Minepit 2",
}

# BGR colors as the reference draws them (`Detect_OBB.py:59-72`).
CLASS_COLORS = {
    0: (255, 0, 0),
    1: (0, 255, 0),
    2: (0, 0, 255),
    3: (255, 255, 0),
    4: (255, 0, 255),
    5: (0, 255, 255),
    6: (0, 0, 0),
    7: (240, 34, 0),
    8: (50, 20, 60),
    9: (60, 50, 20),
    10: (200, 150, 80),
    11: (100, 200, 150),
}


@dataclass(frozen=True)
class DTEdgeConfig:
    """DT-Edge 4th-channel synthesis knobs (`Detect_OBB.py:29-32`)."""

    sigmas: tuple = (0.0, 0.6, 1.2, 2.4)
    p_hi: int = 90                       # percentile binarize threshold
    morph_open: int = 1
    tau: float = 3.0


@dataclass(frozen=True)
class ScaleConfig:
    """One inference scale: a tile size + overlap + model checkpoint."""

    tile_size: int
    overlap: int
    checkpoint: Optional[str] = None
    model_scale: str = "x"


@dataclass(frozen=True)
class DetectConfig:
    """Tiled inference configuration (`Detect_OBB.py:23-72`)."""

    scales: tuple = (ScaleConfig(128, 30), ScaleConfig(416, 100))
    channels: int = 3                    # 3 or 4 (RGB + DT-Edge)
    nc: int = 12
    calculate_metrics: bool = False
    conf_thr_metrics: float = 0.001
    conf_thr_predict: float = 0.25
    engine_nms_iou: float = 0.7          # in-engine rotated NMS
    merge_iou: float = 0.4               # global/per-tile merge
    metrics_iou: float = 0.25
    map_min_score: float = 0.001
    apply_border_filter: bool = True
    margin_128: int = 10
    margin_416: int = 20
    max_det_per_tile: int = 64
    pre_topk: int = 256
    dt_edge: DTEdgeConfig = field(default_factory=DTEdgeConfig)


def _preset_detect(**kw) -> DetectConfig:
    return dataclasses.replace(DetectConfig(), **kw)


# the detection presets of BASELINE.json's configurations
PRESETS = {
    # single-scale 3ch detection: tile 416 / overlap 100
    "detect_416": _preset_detect(scales=(ScaleConfig(416, 100),)),
    # single-scale small-tile detection: tile 128 / overlap 30
    "detect_128": _preset_detect(scales=(ScaleConfig(128, 30),)),
    # 4-channel RGB + DT-Edge single-scale
    "detect_416_4ch": _preset_detect(
        scales=(ScaleConfig(416, 100),), channels=4),
    # dual-scale [128, 416] with consensus late fusion + metrics suite
    "detect_dual": _preset_detect(calculate_metrics=True),
}
