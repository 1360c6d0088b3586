"""Rotated RTMDet (Lyu et al., arXiv:2212.07784; mmrotate 1.x
``configs/rotated_rtmdet/rotated_rtmdet_l-3x-dota.py``): mmdet's CSPNeXt P5
backbone (a stem of three 3x3 ConvBNs, four stages of a stride-2 ConvBN and
a CSPLayer of CSPNeXt blocks with channel attention, SPP before the last),
the CSPNeXtPAFPN neck (1x1 reduces, two top-down and two bottom-up
CSPLayers without identity, 3x3 out convs) and mmrotate's
``RotatedRTMDetSepBNHead`` (two stacked 3x3 ConvBNs a branch whose convs
are shared over the three levels, a BatchNorm for each level; 1x1
``rtm_cls``, ``rtm_reg`` and ``rtm_ang`` with biases; no objectness).

Parameter names are mmrotate's (``backbone.stage1.1.blocks.0.conv2.
depthwise_conv.conv.weight``, ``neck.top_down_blocks.0.final_conv.bn.
running_var``, ``bbox_head.cls_convs.2.1.bn.weight``). The state dict
holds the shared head convs once for each level, as mmrotate's does;
folding them (``fold.py``) gives each level its own kernel, so a model
built with ``fused_bn=True`` keeps one conv a level.

BatchNorm's eps is mmcv's 1e-5. The input is BGR, less the mean, over the
std (``models/archs.py``). The forward returns the raw per-level head
outputs in the compute dtype; mmrotate's head applies ``exp`` and the
stride to ``rtm_reg`` in its forward, and here ``models/decode.py`` does
the same arithmetic, in float32, in the decode."""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import (BatchNorm, Conv2d, ConvBN, CSPLayer, CSPNEXT,
                     SPPBottleneck, upsample2x)

# scale -> (deepen, widen), mmdet's rtmdet_{tiny,s,m,l,x} configs
SCALES = {"tiny": (0.167, 0.375), "s": (0.33, 0.5), "m": (0.67, 0.75),
          "l": (1.0, 1.0), "x": (1.33, 1.25)}
STRIDES = (8, 16, 32)
BN_EPS = 1e-5          # mmcv's BatchNorm default, under norm_cfg SyncBN
# CSPNeXt P5: (in, out, blocks, add_identity, spp) a stage, before widening
STAGES = ((64, 128, 3, True, False), (128, 256, 6, True, False),
          (256, 512, 6, True, False), (512, 1024, 3, False, True))


class CSPNeXt(nn.Module):
    def __init__(self, d: float, w: float, in_channels: int):
        super().__init__()
        c0 = int(STAGES[0][0] * w)
        self.stem = nn.Sequential(ConvBN(in_channels, c0 // 2, 3, 2),
                                  ConvBN(c0 // 2, c0 // 2, 3),
                                  ConvBN(c0 // 2, c0, 3))
        for i, (c1, c2, n, identity, spp) in enumerate(STAGES):
            c1, c2 = int(c1 * w), int(c2 * w)
            stage = [ConvBN(c1, c2, 3, 2)]
            if spp:
                stage.append(SPPBottleneck(c2, c2))
            stage.append(CSPLayer(c2, c2, max(round(n * d), 1), identity,
                                  channel_attention=True))
            self.add_module(f"stage{i + 1}", nn.Sequential(*stage))

    def forward(self, x):
        x = self.stage2(self.stage1(self.stem(x)))
        p4 = self.stage3(x)
        return x, p4, self.stage4(p4)


class CSPNeXtPAFPN(nn.Module):
    def __init__(self, chs: tuple, c_out: int, n: int):
        super().__init__()
        c3, c4, c5 = chs
        self.reduce_layers = nn.ModuleList([ConvBN(c5, c4, 1),
                                            ConvBN(c4, c3, 1)])
        self.top_down_blocks = nn.ModuleList([
            CSPLayer(2 * c4, c4, n, False), CSPLayer(2 * c3, c3, n, False)])
        self.downsamples = nn.ModuleList([ConvBN(c3, c3, 3, 2),
                                          ConvBN(c4, c4, 3, 2)])
        self.bottom_up_blocks = nn.ModuleList([
            CSPLayer(2 * c3, c4, n, False), CSPLayer(2 * c4, c5, n, False)])
        self.out_convs = nn.ModuleList(ConvBN(c, c_out, 3) for c in chs)

    def forward(self, feats):
        p3, p4, p5 = feats
        r5 = self.reduce_layers[0](p5)
        n4 = self.top_down_blocks[0](torch.cat([upsample2x(r5), p4], 1))
        r4 = self.reduce_layers[1](n4)
        n3 = self.top_down_blocks[1](torch.cat([upsample2x(r4), p3], 1))
        o4 = self.bottom_up_blocks[0](torch.cat(
            [self.downsamples[0](n3), r4], 1))
        o5 = self.bottom_up_blocks[1](torch.cat(
            [self.downsamples[1](o4), r5], 1))
        return [m(x) for m, x in zip(self.out_convs, (n3, o4, o5))]


class RotatedRTMDetSepBNHead(nn.Module):
    def __init__(self, nc: int, c: int, stacked: int = 2,
                 share_conv: bool = True):
        super().__init__()
        branch = lambda: nn.ModuleList(nn.ModuleList(
            ConvBN(c, c, 3) for _ in range(stacked)) for _ in STRIDES)
        self.cls_convs, self.reg_convs = branch(), branch()
        pred = lambda n: nn.ModuleList(Conv2d(c, n, 1) for _ in STRIDES)
        self.rtm_cls, self.rtm_reg, self.rtm_ang = pred(nc), pred(4), pred(1)
        if share_conv:
            for convs in (self.cls_convs, self.reg_convs):
                for level in convs[1:]:
                    for i, m in enumerate(level):
                        m.conv = convs[0][i].conv

    def forward(self, feats):
        out = {"cls": [], "reg": [], "ang": []}
        for i, x in enumerate(feats):
            c, r = x, x
            for m in self.cls_convs[i]:
                c = m(c)
            for m in self.reg_convs[i]:
                r = m(r)
            out["cls"].append(self.rtm_cls[i](c))
            out["reg"].append(self.rtm_reg[i](r))
            out["ang"].append(self.rtm_ang[i](r))
        return out


class RTMDetR(nn.Module):
    """Full detector. forward(x [B, 3, H, W] float, BGR less the mean over
    the std, H and W divisible by 32) -> {"cls", "reg", "ang"}: per-level
    raw head outputs [B, nc | 4 | 1, Hi, Wi] in the input's dtype, ``reg``
    before mmrotate's ``exp() * stride``. ``fused_bn=True`` runs the fused
    conv + bias graph for BN-folded weights (``fold.py`` at ``BN_EPS``),
    for inference only, with a head conv a level."""

    def __init__(self, nc: int = 12, scale: str = "l", in_channels: int = 3,
                 fused_bn: bool = False):
        super().__init__()
        if in_channels != 3:
            raise ValueError(f"RTMDet-R takes a 3-channel BGR input, not "
                             f"{in_channels} channels")
        d, w = SCALES[scale]
        chs = tuple(int(c * w) for c in (256, 512, 1024))
        self.backbone = CSPNeXt(d, w, in_channels)
        self.neck = CSPNeXtPAFPN(chs, int(256 * w), round(3 * d))
        self.bbox_head = RotatedRTMDetSepBNHead(nc, int(256 * w),
                                                share_conv=not fused_bn)
        for m in self.modules():
            if isinstance(m, ConvBN):
                m.fused = fused_bn
            if isinstance(m, BatchNorm):
                m.eps = BN_EPS

    def forward(self, x: torch.Tensor) -> dict:
        CSPNEXT["tiles"] += x.shape[0]
        return self.bbox_head(self.neck(self.backbone(x)))
