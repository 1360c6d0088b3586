"""YOLO11 building blocks as NCHW ``nn.Module``s with ultralytics' module
names, so that a state dict has ultralytics' keys: ConvBN (ultralytics
``Conv``), Bottleneck, C3k, C3k2, SPPF, Attention, PSABlock, C2PSA and the
nearest-neighbour 2x upsample.

BatchNorm uses eps 1e-3 like ultralytics. In training mode it follows
flax's ``nn.BatchNorm`` (the JAX package's), not ``nn.BatchNorm2d``'s
update: see ``BatchNorm``. A ConvBN whose ``fused`` flag is set runs the
fused inference graph, conv + BN bias + SiLU, which is right once
``fold.fold_bn_state`` has folded the BatchNorm into the conv weights.

Every module computes in its input's dtype, as flax's ``dtype=x.dtype``
modules of the JAX package do: a conv casts its float32 weight and bias to
that dtype in ``forward``, so the cast of the network's input alone sets
the compute dtype (bf16 or float32) and the float32 parameters get float32
gradients. BatchNorm takes its moments and normalises in float32 and
returns the input's dtype; attention takes its logits and softmax in
float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import distributed as PD

BN_EPS = 1e-3
BN_MOMENTUM = 0.97  # flax's: running = 0.97 * running + 0.03 * batch


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` promoted to float32 if it is narrower (bf16), else ``x``."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with flax's training semantics. The batch statistics are
    flax's fast form, mean and E[x^2] - mean^2 clipped at 0 (the biased
    variance), and the output is (x - mean) * (rsqrt(var + eps) * weight) +
    bias. The running statistics move by 0.03 toward the batch mean and the
    *biased* batch variance; ``nn.BatchNorm2d`` would use the unbiased one,
    n/(n-1) times larger (twice as large on a 1x1 map at batch 2).
    ``num_batches_tracked`` is not used. Eval mode is ``nn.BatchNorm2d``'s:
    the running statistics. Inside a data-parallel group of more than one
    process the statistics are the global batch's (``global_moments``), so
    every process moves its running statistics alike."""

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)

    def forward(self, x):
        # flax promotes a bf16 input to float32 for the moments and the
        # normalisation and casts the result back
        xf = at_least_float32(x)
        if not self.training:
            return super().forward(xf).to(x.dtype)
        if PD.world() > 1:
            mean, var = global_moments(xf)
        else:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3))
                                  - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(
                mean.detach() * (1.0 - BN_MOMENTUM))
            self.running_var.mul_(BN_MOMENTUM).add_(
                var.detach() * (1.0 - BN_MOMENTUM))
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None]).to(x.dtype)


def global_moments(x: torch.Tensor) -> tuple:
    """Flax's fast batch moments over every process's rows (the JAX
    package's BatchNorm under its data mesh): one all-reduce of the packed
    ``[sum x, sum x^2, count]`` a layer, through which the gradient flows
    (its backward is one more). Returns (mean, E[x^2] - mean^2 clipped at
    0), in float32 or wider whatever the dtype of ``x``."""
    x = at_least_float32(x)
    c = x.shape[1]
    packed = PD.all_reduce_sum(torch.cat([
        x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
        x.new_full((1,), x.numel() // c)]))
    mean = packed[:c] / packed[2 * c]
    return mean, torch.clamp_min(packed[c:2 * c] / packed[2 * c]
                                 - mean * mean, 0.0)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype, at flax's cast points
    (``nn.Conv(dtype=x.dtype)``): the weight is cast to it and the
    convolution rounded to it, then the bias, cast too, is added; a bf16
    bias inside the convolution would round once, where the JAX package
    rounds twice, and moves the train step's box loss away from the JAX
    package's (``tests/test_torch_bf16_train.py``)."""

    def forward(self, x):
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        if self.bias is None:
            return y
        return y.add_(self.bias.to(x.dtype)[:, None, None])


class ConvBN(nn.Module):
    """Conv2d (no bias) + BatchNorm + SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = BatchNorm(c2)
        self.act = act
        self.fused = False

    def forward(self, x):
        if self.fused:
            # the folded BatchNorm is its bias, added to the convolution's
            # output in the input's dtype, as the JAX package's FoldedBN
            x = self.conv(x).add_(self.bn.bias.to(x.dtype)[:, None, None])
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
        # logits and softmax in float32 (exact products of the bf16 q, k,
        # as JAX's preferred_element_type=float32), the probabilities cast
        # back for the product with v
        attn = torch.matmul(at_least_float32(q.transpose(-2, -1)),
                            at_least_float32(k)) * self.scale
        attn = attn.softmax(dim=-1).to(x.dtype)
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
