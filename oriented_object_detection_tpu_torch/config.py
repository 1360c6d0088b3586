"""Typed configuration for the port: the DT-Edge, scale, detection and
training knobs and the presets, copied from the JAX package's ``config.py``
so that the port reads no module of it."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

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
    bin_method: str = "percentile"       # "percentile" | "otsu"
    p_hi: int = 90                       # percentile binarize threshold
    p_lo: int = 65                       # config surface only: nothing reads it
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
    # the network's compute dtype: "bfloat16" (the JAX package's default)
    # or "float32"; parameters, decode and NMS stay float32
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        torch_dtype(self.compute_dtype)


@dataclass(frozen=True)
class TrainConfig:
    """Training and dataset-build configuration (`Train_OBB.py:19-42`).
    ``compute_dtype`` is the forward's and backward's dtype, bf16 by
    default as in the JAX package; the parameters, their gradients, the
    optimizer state, the EMA and the BatchNorm statistics stay float32.
    Data parallelism is ``--dist`` (``parallel/``), so there is no mesh
    axis."""

    channels: int = 3
    apply_filtered_rgb: bool = False
    need_cropping: bool = True
    need_augmentation: bool = True
    tile_size: int = 416
    overlap: int = 100
    epochs: int = 150
    batch_size: int = 16
    object_boundary_threshold: float = 0.1
    class_balance_threshold: int = 800
    augmentation_repeats: int = 2
    r_target: int = 4                    # empty:positive tile budget
    model_scale: str = "x"
    nc: int = 12
    # optimizer (per-size hyperparameters, `Train_OBB.py:796-841`)
    lr0: float = 0.003
    lrf: float = 0.05
    weight_decay: float = 0.001
    momentum: float = 0.937
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8       # momentum ramp start (-> momentum)
    warmup_bias_lr: float = 0.1        # bias-group lr ramp start (-> lr0)
    # passed by the reference (`Train_OBB.py:809,834`), inert for OBB
    dropout: float = 0.0
    patience: int = 50
    # the engine's dataloader knobs (`Train_OBB.py:30-32`), kept for the
    # config surface: the tile cache on the device takes their place
    workers: int = 2
    cache: bool = False
    rect: bool = False
    # mosaic off for the final N epochs (the engine's close_mosaic=10)
    close_mosaic: int = 10
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    # loss gains (engine defaults)
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    seed: int = 42
    # run-dir artifacts: results.csv/png, args.yaml, train_batch0.jpg
    # (the reference trains with plots=True, `Train_OBB.py:811,839`)
    plots: bool = True
    # optimizer steps per group; the steps run one after another, so the
    # result is that of single steps
    steps_per_dispatch: int = 1
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        torch_dtype(self.compute_dtype)


COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` of a ``compute_dtype`` string; anything but
    "bfloat16" and "float32" raises (the JAX package would quietly take
    float32 for it)."""
    try:
        return COMPUTE_DTYPES[name]
    except KeyError:
        raise ValueError(f"compute_dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, got {name!r}") from None


def _preset_detect(**kw) -> DetectConfig:
    return dataclasses.replace(DetectConfig(), **kw)


# the presets of BASELINE.json's configurations
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
    # Train_OBB end to end: YOLO11x-OBB, 3 channels, 416/100, batch 16
    "train_416": TrainConfig(),
}
