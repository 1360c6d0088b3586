"""YOLO12-OBB network (ultralytics ``cfg/models/12/yolo12-obb.yaml``;
Tian, Ye and Doermann, arXiv:2502.12524): YOLO11's stem and C3k2 stages
up to P4, then two residual area-attention stages (``A2C2f``: area 4 at
P4, one global area at P5), a neck of A2C2f stages with C3k inside and
YOLO11's 3-level OBB head. ``self.model[str(i)]`` holds layer i of the
yaml, so state-dict keys are ultralytics' (``model.6.m.0.1.attn.qkv.conv.
weight``, ``model.6.gamma``, ``model.21.cv3.0.2.bias``); indices 9, 10,
12, 13, 16 and 19 are the yaml's upsamples and concatenations. All five
compound scales and 3- or 4-channel stems; the memory order of the input
is kept, as in ``YOLO11OBB``."""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import A2C2f, C3k2, ConvBN, upsample2x
from .yolo11_obb import SCALES, OBBHead, _ch


class YOLO12OBB(nn.Module):
    """Full detector. forward(x [B, C, H, W] float, already /255, H and W
    divisible by 32, and H * W / 256 divisible by 4 for the P4 areas) ->
    {"box", "cls", "ang"}: per-level raw head outputs in the input's dtype.
    ``fused_bn=True`` runs the fused conv + bias graph for BN-folded
    weights (``fold.py``), for inference only. At scales l and x every
    A2C2f is residual (``gamma``) with an MLP ratio of 1.2, at n, s and m
    it is not and the ratio is 2.0 (ultralytics' ``parse_model``)."""

    def __init__(self, nc: int = 12, scale: str = "x", in_channels: int = 3,
                 reg_max: int = 16, ne: int = 1, fused_bn: bool = False):
        super().__init__()
        d, w, mc = SCALES[scale]
        ch = lambda c: _ch(c, w, mc)
        rep = lambda n: max(round(n * d), 1)
        c3k = scale in ("m", "l", "x")
        att = dict(residual=True, mlp_ratio=1.2) if scale in ("l", "x") \
            else dict(residual=False, mlp_ratio=2.0)
        c64, c128, c256, c512, c1024 = (ch(c) for c in
                                        (64, 128, 256, 512, 1024))
        layers = {
            0: ConvBN(in_channels, c64, 3, 2),
            1: ConvBN(c64, c128, 3, 2),
            2: C3k2(c128, c256, rep(2), c3k, e=0.25),
            3: ConvBN(c256, c256, 3, 2),
            4: C3k2(c256, c512, rep(2), c3k, e=0.25),
            5: ConvBN(c512, c512, 3, 2),
            6: A2C2f(c512, c512, rep(4), True, 4, **att),
            7: ConvBN(c512, c1024, 3, 2),
            8: A2C2f(c1024, c1024, rep(4), True, 1, **att),
            11: A2C2f(c1024 + c512, c512, rep(2), False, -1, **att),
            14: A2C2f(c512 + c512, c256, rep(2), False, -1, **att),
            15: ConvBN(c256, c256, 3, 2),
            17: A2C2f(c256 + c512, c512, rep(2), False, -1, **att),
            18: ConvBN(c512, c512, 3, 2),
            20: C3k2(c512 + c1024, c1024, rep(2), True),
            21: OBBHead(nc, (c256, c512, c1024), reg_max, ne,
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
        p5b = L["8"](L["7"](p4b))
        n11 = L["11"](torch.cat([upsample2x(p5b), p4b], 1))
        p3 = L["14"](torch.cat([upsample2x(n11), p3b], 1))
        p4 = L["17"](torch.cat([L["15"](p3), n11], 1))
        p5 = L["20"](torch.cat([L["18"](p4), p5b], 1))
        return L["21"]((p3, p4, p5))
