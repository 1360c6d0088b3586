"""The detector architectures by the name a checkpoint records in
``extra["arch"]`` ("yolo11" where it records none): each one's network, its
tile input, its decode and its BatchNorm eps. The detect path
(``infer/pipeline.py``) takes all four from here.

* ``pixels(bgr, channels, dt_edge)``: uint8 BGR [B, H, W, 3] -> float32
  [B, C, H, W] in 0..255 (``ops/dtedge.build_multich`` for YOLO: RGB, and
  the DT-Edge channel for 4 channels; BGR as it comes for RTMDet-R).
* ``normalise(x)``: those pixels -> the network's float32 input (YOLO's
  ``/ 255``; RTMDet-R's ``(x - mean) / std`` in BGR order, mmdet's
  ``DetDataPreprocessor`` with ``bgr_to_rgb=False``).
* ``decode(out, tile)``: the raw head outputs -> (xywhr [B, A, 5] in tile
  pixels, scores [B, A, nc]), which ``decode.postprocess_batch`` takes.
* ``bn_eps``: the eps ``fold.fold_bn_state`` folds with (ultralytics'
  1e-3, mmcv's 1e-5)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..ops import dtedge as DT
from . import decode as D
from . import rtmdet_r
from .layers import BN_EPS
from .yolo11_obb import YOLO11OBB
from .yolo12_obb import YOLO12OBB

# mmrotate's rotated_rtmdet data_preprocessor, BGR order
RTMDET_MEAN = (103.53, 116.28, 123.675)
RTMDET_STD = (57.375, 57.12, 58.395)


@dataclass(frozen=True)
class Arch:
    model: type
    pixels: Callable
    normalise: Callable
    decode: Callable
    bn_eps: float


def yolo_normalise(x: torch.Tensor) -> torch.Tensor:
    return x / 255.0


def bgr_pixels(bgr: torch.Tensor, channels: int, dt_edge=None
               ) -> torch.Tensor:
    if channels != 3:
        raise ValueError(f"RTMDet-R takes 3 channels, got {channels}")
    return bgr.to(torch.float32).permute(0, 3, 1, 2)


def rtmdet_normalise(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(RTMDET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(RTMDET_STD, device=x.device)[:, None, None]
    return (x - mean) / std


_YOLO = dict(pixels=DT.build_multich, normalise=yolo_normalise,
             decode=D.decode_raw, bn_eps=BN_EPS)
ARCHS = {"yolo11": Arch(YOLO11OBB, **_YOLO),
         "yolo12": Arch(YOLO12OBB, **_YOLO),
         "rtmdet_r": Arch(rtmdet_r.RTMDetR, bgr_pixels, rtmdet_normalise,
                          D.decode_distance_angle, rtmdet_r.BN_EPS)}


def arch(name: str) -> Arch:
    """The architecture ``name``."""
    if name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; known: "
                         f"{sorted(ARCHS)}")
    return ARCHS[name]


def model_class(name: str):
    """The ``nn.Module`` class of architecture ``name``."""
    return arch(name).model
