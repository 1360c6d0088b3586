"""YOLO11 building blocks as NCHW ``nn.Module``s with ultralytics' module
names, so that a state dict has ultralytics' keys: ConvBN (ultralytics
``Conv``), Bottleneck, C3k, C3k2, SPPF, Attention, PSABlock, C2PSA and the
nearest-neighbour 2x upsample.

BatchNorm uses eps 1e-3 like ultralytics. A ConvBN whose ``fused`` flag is
set runs the fused inference graph, conv + BN bias + SiLU, which is right
once ``fold.fold_bn_state`` has folded the BatchNorm into the conv weights.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm + SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=BN_EPS)
        self.act = act
        self.fused = False

    def forward(self, x):
        if self.fused:
            c = self.conv
            x = F.conv2d(x, c.weight, self.bn.bias, c.stride, c.padding,
                         c.dilation, c.groups)
        else:
            x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 k: tuple = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, k[0])
        self.cv2 = ConvBN(c_, c2, k[1])
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    """C3 block with n inner bottlenecks of kernel k (e=1.0)."""

    def __init__(self, c1: int, c2: int, n: int = 2, shortcut: bool = True,
                 e: float = 0.5, k: int = 3):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN(c1, c_, 1)
        self.cv3 = ConvBN(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, (k, k), 1.0)
                                 for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k2(nn.Module):
    """C2f-style split/grow/concat block; inner units are C3k (c3k=True)
    or plain Bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False,
                 e: float = 0.5, shortcut: bool = True):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * c, 1)
        self.cv2 = ConvBN((2 + n) * c, c2, 1)
        self.m = nn.ModuleList(
            C3k(c, c, 2, shortcut) if c3k
            else Bottleneck(c, c, shortcut, (3, 3), 0.5) for _ in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).split(self.c, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained stride-1 maxpools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN(c_ * 4, c2, 1)
        self.k = k

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(ys, 1))


class Attention(nn.Module):
    """PSA multi-head attention over the flattened spatial dim with a
    depthwise positional-encoding branch. The qkv channels are grouped
    head-major, as ultralytics' ``view(B, nh, 2*kd + hd, N)``."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        h = dim + self.key_dim * num_heads * 2
        self.qkv = ConvBN(dim, h, 1, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 3, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        qkv = self.qkv(x).view(B, self.num_heads,
                               2 * self.key_dim + self.head_dim, N)
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim],
                            dim=2)
        attn = torch.matmul(q.transpose(-2, -1), k) * self.scale
        attn = attn.softmax(dim=-1)
        out = torch.matmul(v, attn.transpose(-2, -1)).view(B, C, H, W)
        out = out + self.pe(v.reshape(B, C, H, W))
        return self.proj(out)


class PSABlock(nn.Module):
    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.attn = Attention(c, num_heads)
        self.ffn = nn.Sequential(ConvBN(c, 2 * c, 1),
                                 ConvBN(2 * c, c, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    """Partial self-attention stage: split, run PSA blocks on half, rejoin."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * c, 1)
        self.cv2 = ConvBN(2 * c, c2, 1)
        self.m = nn.Sequential(*(PSABlock(c, max(1, c // 64))
                                 for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).split(self.c, 1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (NCHW)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
