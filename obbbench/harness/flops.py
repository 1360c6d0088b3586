"""The yardstick's operation counts and peaks.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over the
benchmark's frozen reference model on the meta device (convolutions and
matrix products, two a multiply-add), one tile at a time, so a change to
the program's implementation cannot move the denominator. This is
YOLO11-OBB's count, which ``archs/yolo11_obb.py`` and the training
driver read; another architecture counts its own reference model in its
module. A training step counts three forwards (forward, and the two
products of the backward)."""

from __future__ import annotations

import functools

import torch

# NVIDIA H100 SXM data sheet, dense, no sparsity, at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


@functools.lru_cache(maxsize=None)
def forward_flops(model_scale: str, tile: int, nc: int = 12,
                  channels: int = 3) -> float:
    """FLOPs of one forward of one ``tile`` x ``tile`` input."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference import model as M

    with torch.device("meta"):
        net = M.YOLO11OBB(nc=nc, scale=model_scale, in_channels=channels)
        x = torch.zeros(1, channels, tile, tile)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(x)
    return float(counter.get_total_flops())


def train_step_flops(model_scale: str, tile: int, batch: int,
                     nc: int = 12, channels: int = 3) -> float:
    return 3.0 * batch * forward_flops(model_scale, tile, nc, channels)
