"""YOLO11 and YOLO12 building blocks as NCHW ``nn.Module``s with
ultralytics' module names, so that a state dict has ultralytics' keys:
ConvBN (ultralytics ``Conv``), Bottleneck, C3k, C3k2, SPPF, Attention,
PSABlock, C2PSA, YOLO12's area attention (AAttn, ABlock, A2C2f) and the
nearest-neighbour 2x upsample; and RTMDet's CSPNeXt blocks with mmdet's
module names (CSPNeXtBlock, ChannelAttention, CSPLayer, SPPBottleneck),
whose ConvBN is mmcv's ``ConvModule``.

BatchNorm uses eps 1e-3 like ultralytics (``models/rtmdet_r.py`` sets
mmcv's 1e-5 on its own). In training mode it follows
flax's ``nn.BatchNorm`` (the JAX package's), not ``nn.BatchNorm2d``'s
update: see ``BatchNorm``. A ConvBN whose ``fused`` flag is set runs the
fused inference graph, conv + BN bias + SiLU, which is right once
``fold.fold_bn_state`` has folded the BatchNorm into the conv weights; the
bias and SiLU are one pass, ``ops/epilogue.py``, a kernel on the card.

Where its ConvBNs are fused, a block with a concatenation (C3k2, C3k,
A2C2f) builds it in place: it allocates the concatenation once and each
part's epilogue stores the part into its channel slice, with the residual
add of a Bottleneck, an ABlock's MLP and A2C2f's ``x + gamma * y`` folded
into the epilogue of the ConvBN that produces it. An ABlock's attention
residual stays a separate add: ``AAttn.forward`` takes ``x`` alone. A part that the next
module reads is also stored packed, since cuDNN reads packed inputs.
Each block's ``forward_plain`` is the form with ``torch.cat`` and separate
adds: the training path (``fused`` unset), and the reference the in-place
form is held to, bit for bit.

Layout: shapes are NCHW, and every module keeps its input's memory order.
Training runs NCHW (contiguous) tensors. On the card the detector holds
its conv weights and its input channels-last (NHWC order,
``infer/pipeline.py``), so cuDNN runs its NHWC kernels with no layout
transposes around them, and every op between two convs keeps that order:
the concatenations, splits, max pools, residual adds and ``upsample2x``,
and ``Attention`` and ``AAttn``, whose views hold in both orders.

Every module computes in its input's dtype, as flax's ``dtype=x.dtype``
modules of the JAX package do: a conv casts its float32 weight and bias to
that dtype in ``forward``, so the cast of the network's input alone sets
the compute dtype (bf16 or float32) and the float32 parameters get float32
gradients. BatchNorm takes its moments and normalises in float32 and
returns the input's dtype; attention takes its logits and softmax in
float32 (``AAttn`` through ``F.scaled_dot_product_attention``, whose
kernels accumulate the logits and take the softmax in float32 and
multiply the probabilities, in the input's dtype, with v).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.epilogue import bias_silu_nhwc
from ..parallel import mesh as PM
from ..utils import profiling as prof

BN_EPS = 1e-3
BN_MOMENTUM = 0.97  # flax's: running = 0.97 * running + 0.03 * batch

# AAttn forwards: calls, areas (attention groups of a batch) and tokens
AREA_ATTN = {"calls": 0, "areas": 0, "tokens": 0}
# CSPNeXtBlock and ChannelAttention forwards, the depthwise ConvBNs among
# them, and the tiles through an RTMDet-R forward (``models/rtmdet_r.py``)
CSPNEXT = {"blocks": 0, "depthwise": 0, "channel_attn": 0, "tiles": 0}


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
    the running statistics. When the global batch is split over more than
    one process (the world, or the data group of the active mesh:
    ``parallel/mesh.py``) the statistics are the global batch's
    (``global_moments``), so every process moves its running statistics
    alike."""

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)

    def forward(self, x):
        # flax promotes a bf16 input to float32 for the moments and the
        # normalisation and casts the result back
        xf = at_least_float32(x)
        if not self.training:
            return super().forward(xf).to(x.dtype)
        if PM.data_size() > 1:
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
    """Flax's fast batch moments over the rows of every process of the data
    axis (the JAX package's BatchNorm under its data mesh): one all-reduce
    of the packed ``[sum x, sum x^2, count]`` a layer, through which the
    gradient flows (its backward is one more). Returns (mean, E[x^2] -
    mean^2 clipped at 0), in float32 or wider whatever the dtype of
    ``x``."""
    x = at_least_float32(x)
    c = x.shape[1]
    packed = PM.data_sum(torch.cat([
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
    """Conv2d (no bias) + BatchNorm + SiLU. With ``fused`` set (the
    detector's folded weights), the folded BatchNorm is the bias, added to
    the convolution's output in the input's dtype as the JAX package's
    FoldedBN adds it, and SiLU follows: both in one pass
    (``ops/epilogue.py``; channels-last on the card), with no backward,
    which also takes ``scale * y`` and ``residual + y`` and stores the
    result in place or to the destinations ``outs`` (``(tensor, first
    channel)`` pairs). Those three arguments are for a fused ConvBN only."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = BatchNorm(c2)
        self.act = act
        self.fused = False

    def forward(self, x, outs=(), residual=None, scale=None):
        if self.fused:
            return bias_silu_nhwc(self.conv(x), self.bn.bias, self.act,
                                  outs, residual, scale)
        if outs or residual is not None or scale is not None:
            raise ValueError("ConvBN: outs, residual and scale need a "
                             "fused ConvBN")
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


def concat_buffer(x: torch.Tensor, channels: int) -> torch.Tensor:
    """An empty [N, channels, H, W] tensor of ``x``'s batch, size, dtype
    and device, channels-last where ``x`` is (the card's forward), else
    NCHW: a block's concatenation, or a packed part of one."""
    N, _, H, W = x.shape
    fmt = (torch.channels_last if x.is_contiguous(
        memory_format=torch.channels_last) else torch.contiguous_format)
    return torch.empty((N, channels, H, W), dtype=x.dtype, device=x.device,
                       memory_format=fmt)


def run_into(m: nn.Module, x: torch.Tensor, outs) -> torch.Tensor:
    """``m(x)`` with its result stored to ``outs``: an ``nn.Sequential``
    hands them to its last module."""
    if isinstance(m, nn.Sequential):
        for block in m[:-1]:
            x = block(x)
        m = m[-1]
    return m(x, outs)


def grow_in_place(cv1: ConvBN, ms, x: torch.Tensor, c: int) -> torch.Tensor:
    """The concatenation of a C2f-style block (C3k2, A2C2f) built in
    place: ``cv1(x)`` and each module of ``ms`` (c channels each, chained
    on the last c channels of the one before) stored into their slices of
    one buffer; every part but the last also packed for the module that
    reads it, and dropped once that module has run. Returns the buffer."""
    k = cv1.conv.out_channels
    buf = concat_buffer(x, k + len(ms) * c)
    part = concat_buffer(x, c)
    cv1(x, [(buf[:, :k], 0), (part, k - c)])
    for i, m in enumerate(ms):
        outs = [(buf[:, k + i * c:k + (i + 1) * c], 0)]
        if i < len(ms) - 1:
            outs.append((concat_buffer(x, c), 0))
        run_into(m, part, outs)
        part = outs[-1][0]
    return buf


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 k: tuple = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, k[0])
        self.cv2 = ConvBN(c_, c2, k[1])
        self.add = shortcut and c1 == c2

    def forward(self, x, outs=()):
        if not self.cv2.fused:
            return self.forward_plain(x)
        return self.cv2(self.cv1(x), outs, x if self.add else None)

    def forward_plain(self, x):
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

    def forward(self, x, outs=()):
        if not self.cv3.fused:
            return self.forward_plain(x)
        c = self.cv1.conv.out_channels
        buf = concat_buffer(x, 2 * c)
        run_into(self.m, self.cv1(x), [(buf[:, :c], 0)])
        self.cv2(x, [(buf[:, c:], 0)])
        return self.cv3(buf, outs)

    def forward_plain(self, x):
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
        if not self.cv2.fused:
            return self.forward_plain(x)
        return self.cv2(grow_in_place(self.cv1, self.m, x, self.c))

    def forward_plain(self, x):
        ys = list(self.cv1(x).split(self.c, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


def spp_cascade(cv1: ConvBN, cv2: ConvBN, x: torch.Tensor,
                k: int = 5) -> torch.Tensor:
    """``cv2(cat[y, pool(y), pool(pool(y)), pool(pool(pool(y)))])`` with
    ``y = cv1(x)`` and ``pool`` a stride-1 k x k max pool."""
    ys = [cv1(x)]
    for _ in range(3):
        ys.append(F.max_pool2d(ys[-1], k, 1, k // 2))
    return cv2(torch.cat(ys, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained stride-1 maxpools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN(c_ * 4, c2, 1)
        self.k = k

    def forward(self, x):
        return spp_cascade(self.cv1, self.cv2, x, self.k)


class Attention(nn.Module):
    """PSA multi-head attention over the flattened spatial dim with a
    depthwise positional-encoding branch. The qkv channels are grouped
    head-major, as ultralytics' ``view(B, nh, 2*kd + hd, N)``. That view
    holds for NCHW and for channels-last order alike (it splits the
    channel axis and merges H with W), so the block keeps its input's
    layout: v is gathered into a tensor of the input's layout for ``pe``,
    and the sum takes ``pe``'s layout."""

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
        pe_in = torch.empty_like(x)
        pe_in.view(B, self.num_heads, self.head_dim, N).copy_(v)
        # a sum takes its first operand's layout: pe's, which is x's
        return self.proj(self.pe(pe_in) + out)


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


def area_tokens(t: torch.Tensor, area: int, heads: int) -> torch.Tensor:
    """[B, C, H, W] -> the view [B, area, N / area, heads, C / heads] of its
    tokens in row-major (h, w) order, an area being a run of N / area
    tokens (a strip of H / area rows), channel ``head * C / heads + j`` at
    [..., head, j]. A view in NCHW and in channels-last order alike."""
    B, C, H, W = t.shape
    return t.permute(0, 2, 3, 1).view(B, area, H * W // area, heads,
                                      C // heads)


class AAttn(nn.Module):
    """YOLO12's area attention (ultralytics ``AAttn``): the qkv 1x1 ConvBN,
    the tokens cut into ``area`` areas of consecutive rows, each head's
    softmax(q k^T / sqrt(d)) v within its area, and ``proj(out + pe(v))``
    with a 7x7 depthwise positional ConvBN. Channel ``head * 3d + j`` of
    qkv is q for j < d, k for d <= j < 2d, v above; the output channel is
    ``head * d + j``.

    q, k and v are views of qkv's output, [B * area, heads, N / area, d]
    with unit stride in d on the card (channels-last), handed as they are
    to ``F.scaled_dot_product_attention``. v is gathered once into a tensor
    of the input's layout for ``pe``, and the attention's output is added
    into ``pe``'s through a view, so the block keeps its input's layout.
    Each forward opens the span ``forward_area_attn`` and counts itself in
    ``AREA_ATTN``."""

    def __init__(self, dim: int, num_heads: int, area: int = 1):
        super().__init__()
        self.area = area
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = ConvBN(dim, 3 * dim, 1, act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 7, g=dim, act=False)

    def forward(self, x):
        with prof.span("forward_area_attn"):
            B, C, H, W = x.shape
            a, h, d = self.area, self.num_heads, self.head_dim
            n = H * W // a
            qkv = area_tokens(self.qkv(x), a, h).reshape(B * a, n, h, 3 * d)
            q, k, v = qkv.transpose(1, 2).split(d, dim=-1)
            out = F.scaled_dot_product_attention(q, k, v)
            pe_in = torch.empty_like(x)
            area_tokens(pe_in, a, h).copy_(v.view(B, a, h, n, d).transpose(
                2, 3))
            y = self.pe(pe_in)
            area_tokens(y, a, h).add_(out.view(B, a, h, n, d).transpose(2, 3))
            AREA_ATTN["calls"] += 1
            AREA_ATTN["areas"] += B * a
            AREA_ATTN["tokens"] += B * H * W
            return self.proj(y)


class ABlock(nn.Module):
    """Area-attention block: ``x + attn(x)``, then ``x + mlp(x)`` with a
    1x1 ConvBN + SiLU to ``int(dim * mlp_ratio)`` channels and a 1x1
    ConvBN back."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2,
                 area: int = 1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(ConvBN(dim, hidden, 1),
                                 ConvBN(hidden, dim, 1, act=False))

    def forward(self, x, outs=()):
        if not self.mlp[1].fused:
            return self.forward_plain(x)
        x = x + self.attn(x)
        return self.mlp[1](self.mlp[0](x), outs, x)

    def forward_plain(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """YOLO12's residual area-attention stage: ``cv1`` to ``c2 / 2``
    channels, ``n`` modules chained on it (two ABlocks each with ``a2``,
    else a C3k), ``cv2`` over the concatenation of all their outputs; with
    ``a2`` and ``residual`` the stage returns ``x + gamma * out``, gamma a
    parameter of one value a channel."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True,
                 area: int = 1, residual: bool = False,
                 mlp_ratio: float = 2.0):
        super().__init__()
        c_ = c2 // 2
        if c_ % 32:
            raise ValueError(f"A2C2f: {c_} hidden channels, not a multiple "
                             f"of the head size 32")
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN((1 + n) * c_, c2, 1)
        self.gamma = (nn.Parameter(torch.full((c2,), 0.01))
                      if a2 and residual else None)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, c_ // 32, mlp_ratio, area)
                            for _ in range(2)))
            if a2 else C3k(c_, c_, 2, True) for _ in range(n))

    def forward(self, x):
        if not self.cv2.fused:
            return self.forward_plain(x)
        y = grow_in_place(self.cv1, self.m, x, self.cv1.conv.out_channels)
        if self.gamma is None:
            return self.cv2(y)
        return self.cv2(y, residual=x, scale=self.gamma)

    def forward_plain(self, x):
        ys = [self.cv1(x)]
        for m in self.m:
            ys.append(m(ys[-1]))
        y = self.cv2(torch.cat(ys, 1))
        if self.gamma is None:
            return y
        return x + self.gamma.to(y.dtype)[:, None, None] * y


class DepthwiseSeparableConv(nn.Module):
    """mmcv's ``DepthwiseSeparableConvModule``: a depthwise k x k ConvBN
    with SiLU (``depthwise_conv``), then a pointwise 1x1 ConvBN with SiLU
    (``pointwise_conv``)."""

    def __init__(self, c1: int, c2: int, k: int):
        super().__init__()
        self.depthwise_conv = ConvBN(c1, c1, k, g=c1)
        self.pointwise_conv = ConvBN(c1, c2, 1)


class CSPNeXtBlock(nn.Module):
    """mmdet's ``CSPNeXtBlock`` (expansion 1): a 3x3 ConvBN (``conv1``),
    then a depthwise 5x5 and a pointwise 1x1 ConvBN (``conv2``), each with
    SiLU, and the input added where ``add_identity``. Each depthwise ConvBN,
    its convolution and its epilogue, is the span ``forward_depthwise``;
    each forward counts itself in ``CSPNEXT``. Fused, the identity is
    folded into the pointwise ConvBN's epilogue, which stores to ``outs``."""

    def __init__(self, c1: int, c2: int, add_identity: bool = True,
                 k: int = 5):
        super().__init__()
        self.conv1 = ConvBN(c1, c2, 3)
        self.conv2 = DepthwiseSeparableConv(c2, c2, k)
        self.add_identity = add_identity and c1 == c2

    def _depthwise(self, x):
        with prof.span("forward_depthwise"):
            y = self.conv2.depthwise_conv(x)
        CSPNEXT["blocks"] += 1
        CSPNEXT["depthwise"] += 1
        return y

    def forward(self, x, outs=()):
        pw = self.conv2.pointwise_conv
        if not pw.fused:
            return self.forward_plain(x)
        return pw(self._depthwise(self.conv1(x)), outs,
                  x if self.add_identity else None)

    def forward_plain(self, x):
        y = self.conv2.pointwise_conv(self._depthwise(self.conv1(x)))
        return y + x if self.add_identity else y


class ChannelAttention(nn.Module):
    """mmdet's ``ChannelAttention``: ``x * hardsigmoid(fc(mean_hw(x)))``,
    ``fc`` a 1x1 conv with a bias. The gate is computed in float32, as
    mmdet computes it outside autocast, and cast to ``x``'s dtype for the
    product."""

    def __init__(self, c: int):
        super().__init__()
        self.fc = Conv2d(c, c, 1, bias=True)

    def forward(self, x):
        gate = F.hardsigmoid(self.fc(at_least_float32(x).mean(
            dim=(2, 3), keepdim=True)))
        CSPNEXT["channel_attn"] += 1
        return x * gate.to(x.dtype)


class CSPLayer(nn.Module):
    """mmdet's ``CSPLayer`` of CSPNeXt blocks: ``final_conv(attention?(
    cat[blocks(main_conv(x)), short_conv(x)]))``, the middle width
    ``0.5 * c2``. Fused, the last block and ``short_conv`` store their
    outputs into their slices of the concatenation."""

    def __init__(self, c1: int, c2: int, n: int = 1,
                 add_identity: bool = True, channel_attention: bool = False):
        super().__init__()
        c_ = int(c2 * 0.5)
        self.main_conv = ConvBN(c1, c_, 1)
        self.short_conv = ConvBN(c1, c_, 1)
        self.final_conv = ConvBN(2 * c_, c2, 1)
        self.blocks = nn.Sequential(*(CSPNeXtBlock(c_, c_, add_identity)
                                      for _ in range(n)))
        self.attention = ChannelAttention(2 * c_) if channel_attention \
            else None

    def _final(self, y):
        if self.attention is not None:
            y = self.attention(y)
        return self.final_conv(y)

    def forward(self, x):
        if not self.final_conv.fused:
            return self.forward_plain(x)
        c = self.main_conv.conv.out_channels
        buf = concat_buffer(x, 2 * c)
        run_into(self.blocks, self.main_conv(x), [(buf[:, :c], 0)])
        self.short_conv(x, [(buf[:, c:], 0)])
        return self._final(buf)

    def forward_plain(self, x):
        return self._final(torch.cat([self.blocks(self.main_conv(x)),
                                      self.short_conv(x)], 1))


class SPPBottleneck(nn.Module):
    """mmdet's ``SPPBottleneck``: 1x1 ConvBN (``conv1``) to half the
    channels, ``cat[x, max5, max9, max13]`` (stride 1, padding k // 2),
    1x1 ConvBN (``conv2``). The pools are SPPF's cascade of 5x5 pools: with
    -inf padding, max9 = max5(max5) and max13 = max5(max9), exactly."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        c_ = c1 // 2
        self.conv1 = ConvBN(c1, c_, 1)
        self.conv2 = ConvBN(4 * c_, c2, 1)

    def forward(self, x):
        return spp_cascade(self.conv1, self.conv2, x)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample, in the input's layout: an NCHW
    (contiguous) input, as training runs, by two ``repeat_interleave``s,
    whose backward sums the gradient in the JAX package's order, bit for
    bit (``F.interpolate``'s does not:
    ``tests/test_torch_epilogue.py::test_upsample_gradient_has_the_reference_bits``);
    any other, such as the detector's channels-last activations on the
    card, by ``F.interpolate``, which keeps the layout and copies the same
    values."""
    if x.is_contiguous():
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
