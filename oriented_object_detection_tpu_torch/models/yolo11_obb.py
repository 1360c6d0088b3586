"""YOLO11-OBB network (NCHW ``nn.Module``), the port of the JAX package's
``models/yolo11_obb.py``: a CSP backbone (Conv stem, C3k2 stages, SPPF,
C2PSA attention), a PAN-FPN neck and a 3-level (strides 8/16/32) OBB head
with DFL box, class and angle branches. ``self.model[str(i)]`` holds
ultralytics' layer i, so state-dict keys are ultralytics' (``model.0.conv.
weight``, ...). All five compound scales and 3- or 4-channel stems.

Shapes are NCHW whatever the memory order: a model moved to
``torch.channels_last`` with an input in that order (the detector on the
card) runs NHWC end to end, and its outputs keep the NCHW shapes
(``layers.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from .layers import C2PSA, C3k2, Conv2d, ConvBN, SPPF, upsample2x

# scale -> (depth, width, max_channels); the yolo11 yaml scales table.
SCALES = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}

STRIDES = (8, 16, 32)


def _ch(base: int, width: float, max_ch: int) -> int:
    """parse_model channel scaling: make_divisible(min(c, max_ch)*width, 8)."""
    c = min(base, max_ch) * width
    return max(8, int(math.ceil(c / 8)) * 8)


class OBBHead(nn.Module):
    """Per-level OBB head: box (4*reg_max DFL logits), cls (nc) and angle
    (ne) raw outputs; decoding lives in ``decode.py``."""

    def __init__(self, nc: int, chs: tuple, reg_max: int, ne: int,
                 c2: int, c3: int, c4: int):
        super().__init__()
        self.cv2 = nn.ModuleList(nn.Sequential(
            ConvBN(x, c2, 3), ConvBN(c2, c2, 3), Conv2d(c2, 4 * reg_max, 1))
            for x in chs)
        self.cv3 = nn.ModuleList(nn.Sequential(
            nn.Sequential(ConvBN(x, x, 3, g=x), ConvBN(x, c3, 1)),
            nn.Sequential(ConvBN(c3, c3, 3, g=c3), ConvBN(c3, c3, 1)),
            Conv2d(c3, nc, 1)) for x in chs)
        self.cv4 = nn.ModuleList(nn.Sequential(
            ConvBN(x, c4, 3), ConvBN(c4, c4, 3), Conv2d(c4, ne, 1))
            for x in chs)

    def forward(self, feats):
        return {"box": [m(x) for m, x in zip(self.cv2, feats)],
                "cls": [m(x) for m, x in zip(self.cv3, feats)],
                "ang": [m(x) for m, x in zip(self.cv4, feats)]}


class YOLO11OBB(nn.Module):
    """Full detector. forward(x [B, C, H, W] float, already /255, H and W
    divisible by 32) -> {"box", "cls", "ang"}: per-level raw head outputs
    [B, 4*reg_max | nc | ne, Hi, Wi] in the input's dtype, the compute
    dtype (``layers.py``). ``fused_bn=True`` runs the fused
    conv + bias graph, for BN-folded weights (``fold.py``): each ConvBN
    finished by one bias + SiLU pass (``ops/epilogue.py``), which also
    builds the blocks' concatenations in place (``layers.py``), for
    inference only."""

    def __init__(self, nc: int = 12, scale: str = "x", in_channels: int = 3,
                 reg_max: int = 16, ne: int = 1, fused_bn: bool = False):
        super().__init__()
        d, w, mc = SCALES[scale]
        ch = lambda c: _ch(c, w, mc)
        rep = max(1, round(2 * d))
        c3k = scale in ("m", "l", "x")
        c64, c128, c256, c512, c1024 = (ch(c) for c in
                                        (64, 128, 256, 512, 1024))
        layers = {
            0: ConvBN(in_channels, c64, 3, 2),
            1: ConvBN(c64, c128, 3, 2),
            2: C3k2(c128, c256, rep, c3k, e=0.25),
            3: ConvBN(c256, c256, 3, 2),
            4: C3k2(c256, c512, rep, c3k, e=0.25),
            5: ConvBN(c512, c512, 3, 2),
            6: C3k2(c512, c512, rep, True),
            7: ConvBN(c512, c1024, 3, 2),
            8: C3k2(c1024, c1024, rep, True),
            9: SPPF(c1024, c1024, 5),
            10: C2PSA(c1024, c1024, rep),
            13: C3k2(c1024 + c512, c512, rep, c3k),
            16: C3k2(c512 + c512, c256, rep, c3k),
            17: ConvBN(c256, c256, 3, 2),
            19: C3k2(c256 + c512, c512, rep, c3k),
            20: ConvBN(c512, c512, 3, 2),
            22: C3k2(c512 + c1024, c1024, rep, True),
            23: OBBHead(nc, (c256, c512, c1024), reg_max, ne,
                        c2=max(16, c256 // 4, reg_max * 4),
                        c3=max(c256, min(nc, 100)),
                        c4=max(c256 // 4, ne)),
        }
        self.model = nn.ModuleDict({str(i): m for i, m in layers.items()})
        for m in self.modules():
            if isinstance(m, ConvBN):
                m.fused = fused_bn

    def forward(self, x: torch.Tensor) -> dict:
        L = self.model
        x = L["1"](L["0"](x))
        x = L["3"](L["2"](x))
        p3b = L["4"](x)
        p4b = L["6"](L["5"](p3b))
        p5b = L["10"](L["9"](L["8"](L["7"](p4b))))
        n13 = L["13"](torch.cat([upsample2x(p5b), p4b], 1))
        p3 = L["16"](torch.cat([upsample2x(n13), p3b], 1))
        p4 = L["19"](torch.cat([L["17"](p3), n13], 1))
        p5 = L["22"](torch.cat([L["20"](p4), p5b], 1))
        return L["23"]((p3, p4, p5))
