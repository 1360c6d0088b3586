"""The detector architectures by the name a checkpoint records in
``extra["arch"]`` ("yolo11" where it records none)."""

from __future__ import annotations

from .yolo11_obb import YOLO11OBB
from .yolo12_obb import YOLO12OBB

ARCHS = {"yolo11": YOLO11OBB, "yolo12": YOLO12OBB}


def model_class(arch: str):
    """The ``nn.Module`` class of architecture ``arch``."""
    if arch not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r}; known: "
                         f"{sorted(ARCHS)}")
    return ARCHS[arch]
