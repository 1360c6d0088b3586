"""Plain float32 YOLO11-OBB (ultralytics ``yolo11-obb.yaml``), its decode and
the engine's one-shot ProbIoU NMS, written with plain torch operations.

A frozen copy of the arithmetic of the program's plain code, independent
of it: BatchNorm follows flax's training update (eps 1e-3, momentum 0.97,
biased batch variance), inference uses the running statistics unfolded,
and every tensor is float32. Run it with TF32 off.

``precision="fp8"`` is the control: every convolution and attention
product rounds its inputs to float8 e4m3 with a per-tensor scale for the
activations and a per-output-channel scale for the weights (the usual fp8
inference recipe), then computes in float32. Gradients pass the rounding
straight through. ``precision="bf16"`` rounds the same inputs and each
convolution's output to bfloat16 (the cast points of the program's bf16
path), for the look at what bf16 rounding alone moves.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3
BN_MOMENTUM = 0.97
STRIDES = (8, 16, 32)
SCALES = {"n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024),
          "m": (0.50, 1.00, 512), "l": (1.00, 1.00, 512),
          "x": (1.00, 1.50, 512)}
FP8_MAX = 448.0


def fp8_round(t: torch.Tensor, dim=None) -> torch.Tensor:
    """``t`` through float8 e4m3 and back, scaled so that its largest
    magnitude (per ``dim`` slice, or whole) maps to 448."""
    a = t.detach().abs()
    amax = a.amax() if dim is None else a.amax(
        dim=[d for d in range(t.ndim) if d != dim], keepdim=True)
    s = torch.clamp_min(amax, 1e-12) / FP8_MAX
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return t + (q - t).detach()


def bf16_round(t: torch.Tensor, dim=None) -> torch.Tensor:
    return t + (t.detach().to(torch.bfloat16).to(torch.float32)
                - t).detach()


ROUND = {"fp8": fp8_round, "bf16": bf16_round}


class Conv2d(nn.Conv2d):
    precision = "float32"

    def forward(self, x):
        if self.precision == "float32":
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            self.padding, self.dilation, self.groups)
        r = ROUND[self.precision]
        y = r(F.conv2d(r(x), r(self.weight, dim=0), None, self.stride,
                       self.padding, self.dilation, self.groups))
        return y if self.bias is None else y + self.bias[:, None, None]


class BatchNorm(nn.BatchNorm2d):
    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(mean * (1 - BN_MOMENTUM))
            self.running_var.mul_(BN_MOMENTUM).add_(var * (1 - BN_MOMENTUM))
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class ConvBN(nn.Module):
    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = BatchNorm(c2)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBN(c1, c_, k[0])
        self.cv2 = ConvBN(c_, c2, k[1])
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    def __init__(self, c1, c2, n=2, shortcut=True, e=0.5, k=3):
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
    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, shortcut=True):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * c, 1)
        self.cv2 = ConvBN((2 + n) * c, c2, 1)
        self.m = nn.ModuleList(
            C3k(c, c, 2, shortcut) if c3k else
            Bottleneck(c, c, shortcut, (3, 3), 0.5) for _ in range(n))

    def forward(self, x):
        ys = list(self.cv1(x).split(self.c, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))


class SPPF(nn.Module):
    def __init__(self, c1, c2, k=5):
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
    precision = "float32"

    def __init__(self, dim, num_heads, attn_ratio=0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        self.qkv = ConvBN(dim, dim + self.key_dim * num_heads * 2, 1,
                          act=False)
        self.proj = ConvBN(dim, dim, 1, act=False)
        self.pe = ConvBN(dim, dim, 3, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        q, k, v = self.qkv(x).view(
            B, self.num_heads, 2 * self.key_dim + self.head_dim, H * W).split(
            [self.key_dim, self.key_dim, self.head_dim], dim=2)
        r = ROUND.get(self.precision, lambda t: t)
        attn = (torch.matmul(r(q.transpose(-2, -1)), r(k))
                * self.scale).softmax(dim=-1)
        out = torch.matmul(r(v), r(attn.transpose(-2, -1))).view(B, C, H, W)
        return self.proj(out + self.pe(v.reshape(B, C, H, W)))


class PSABlock(nn.Module):
    def __init__(self, c, num_heads):
        super().__init__()
        self.attn = Attention(c, num_heads)
        self.ffn = nn.Sequential(ConvBN(c, 2 * c, 1),
                                 ConvBN(2 * c, c, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    def __init__(self, c1, c2, n=1, e=0.5):
        super().__init__()
        self.c = c = int(c2 * e)
        self.cv1 = ConvBN(c1, 2 * c, 1)
        self.cv2 = ConvBN(2 * c, c2, 1)
        self.m = nn.Sequential(*(PSABlock(c, max(1, c // 64))
                                 for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).split(self.c, 1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


def upsample2x(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _ch(base, width, max_ch):
    return max(8, int(math.ceil(min(base, max_ch) * width / 8)) * 8)


class OBBHead(nn.Module):
    def __init__(self, nc, chs, reg_max, ne, c2, c3, c4):
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
    """forward(x [B, C, H, W] float32 in 0..1) -> per-level raw head
    outputs {"box", "cls", "ang"}."""

    def __init__(self, nc=12, scale="x", in_channels=3, reg_max=16, ne=1):
        super().__init__()
        d, w, mc = SCALES[scale]
        ch = lambda c: _ch(c, w, mc)
        rep = max(1, round(2 * d))
        c3k = scale in ("m", "l", "x")
        c64, c128, c256, c512, c1024 = (ch(c) for c in
                                        (64, 128, 256, 512, 1024))
        layers = {
            0: ConvBN(in_channels, c64, 3, 2), 1: ConvBN(c64, c128, 3, 2),
            2: C3k2(c128, c256, rep, c3k, e=0.25),
            3: ConvBN(c256, c256, 3, 2),
            4: C3k2(c256, c512, rep, c3k, e=0.25),
            5: ConvBN(c512, c512, 3, 2), 6: C3k2(c512, c512, rep, True),
            7: ConvBN(c512, c1024, 3, 2), 8: C3k2(c1024, c1024, rep, True),
            9: SPPF(c1024, c1024, 5), 10: C2PSA(c1024, c1024, rep),
            13: C3k2(c1024 + c512, c512, rep, c3k),
            16: C3k2(c512 + c512, c256, rep, c3k),
            17: ConvBN(c256, c256, 3, 2),
            19: C3k2(c256 + c512, c512, rep, c3k),
            20: ConvBN(c512, c512, 3, 2),
            22: C3k2(c512 + c1024, c1024, rep, True),
            23: OBBHead(nc, (c256, c512, c1024), reg_max, ne,
                        c2=max(16, c256 // 4, reg_max * 4),
                        c3=max(c256, min(nc, 100)), c4=max(c256 // 4, ne)),
        }
        self.model = nn.ModuleDict({str(i): m for i, m in layers.items()})

    def set_precision(self, precision: str) -> "YOLO11OBB":
        if precision not in ("float32", "fp8", "bf16"):
            raise ValueError(f"precision {precision!r}")
        for m in self.modules():
            if isinstance(m, (Conv2d, Attention)):
                m.precision = precision
        return self

    def forward(self, x):
        L = self.model
        x = L["3"](L["2"](L["1"](L["0"](x))))
        p3b = L["4"](x)
        p4b = L["6"](L["5"](p3b))
        p5b = L["10"](L["9"](L["8"](L["7"](p4b))))
        n13 = L["13"](torch.cat([upsample2x(p5b), p4b], 1))
        p3 = L["16"](torch.cat([upsample2x(n13), p3b], 1))
        p4 = L["19"](torch.cat([L["17"](p3), n13], 1))
        p5 = L["22"](torch.cat([L["20"](p4), p5b], 1))
        return L["23"]((p3, p4, p5))


def build(state: dict, scale: str, nc: int = 12, channels: int = 3,
          device="cpu") -> YOLO11OBB:
    """The model with ``state`` (``ckpt.state_dict``) loaded strictly."""
    model = YOLO11OBB(nc=nc, scale=scale, in_channels=channels)
    own = model.state_dict()
    missing = [k for k in own if k not in state
               and not k.endswith("num_batches_tracked")]
    extra = [k for k in state if k not in own]
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing[:3]}, extra "
                       f"{extra[:3]}")
    with torch.no_grad():
        for k, v in own.items():
            if k in state:
                v.copy_(torch.as_tensor(state[k]))
    return model.to(device)


# ---------------------------------------------------------------------------
# Geometry, decode and the engine's NMS
# ---------------------------------------------------------------------------

def xywhr_to_corners8(b):
    cx, cy, w, h, r = b.unbind(-1)
    cos, sin = torch.cos(r), torch.sin(r)
    v1x, v1y, v2x, v2y = w / 2 * cos, w / 2 * sin, -h / 2 * sin, h / 2 * cos
    return torch.stack([cx + v1x + v2x, cy + v1y + v2y,
                        cx + v1x - v2x, cy + v1y - v2y,
                        cx - v1x - v2x, cy - v1y - v2y,
                        cx - v1x + v2x, cy - v1y + v2y], dim=-1)


def corners8_to_xywhr(c8):
    pts = c8.reshape(*c8.shape[:-1], 4, 2)
    c = pts.mean(dim=-2)
    e_w, e_h = pts[..., 0, :] - pts[..., 3, :], pts[..., 0, :] - pts[..., 1, :]
    return torch.stack([c[..., 0], c[..., 1],
                        torch.linalg.vector_norm(e_w, dim=-1),
                        torch.linalg.vector_norm(e_h, dim=-1),
                        torch.atan2(e_w[..., 1], e_w[..., 0])], dim=-1)


def strike_angle(c8):
    ang = torch.atan2(c8[..., 6] - c8[..., 0], c8[..., 7] - c8[..., 1]) \
        * (180.0 / math.pi)
    return torch.where(ang > 0, 180.0 - ang, ang.abs())


def probiou(b1, b2, eps=1e-7):
    def gauss(b):
        w, h, r = b[..., 2], b[..., 3], b[..., 4]
        cos, sin = torch.cos(r), torch.sin(r)
        w2, h2 = w * w / 12.0, h * h / 12.0
        return (w2 * cos * cos + h2 * sin * sin,
                w2 * sin * sin + h2 * cos * cos, (w2 - h2) * cos * sin)

    a1, bb1, c1 = gauss(b1)
    a2, bb2, c2 = gauss(b2)
    dx, dy = b2[..., 0] - b1[..., 0], b2[..., 1] - b1[..., 1]
    sa, sb, sc = a1 + a2, bb1 + bb2, c1 + c2
    denom = torch.clamp_min(sa * sb - sc * sc, eps)
    t1 = ((sa * dy * dy + sb * dx * dx) / denom) * 0.25
    t2 = ((sc * dx * dy * -2.0) / denom) * 0.25
    prod = torch.clamp_min(a1 * bb1 - c1 * c1, 0.0) * torch.clamp_min(
        a2 * bb2 - c2 * c2, 0.0)
    safe = torch.where(prod > 0, prod, torch.ones_like(prod))
    root = torch.where(prod > 0, torch.sqrt(safe), torch.zeros_like(prod))
    t3 = 0.5 * torch.log(denom / (4.0 * root + eps) + eps)
    bd = torch.clamp(t1 + t2 + t3, eps, 100.0)
    return 1.0 - torch.sqrt(1.0 - torch.exp(-bd) + eps)


def make_anchors(img_size, device, offset=0.5):
    pts, sts = [], []
    for s in STRIDES:
        n = img_size // s
        xs = torch.arange(n, dtype=torch.float32, device=device) + offset
        gy, gx = torch.meshgrid(xs, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        sts.append(torch.full((n * n,), float(s), device=device))
    return torch.cat(pts), torch.cat(sts)


def flatten_levels(outs):
    return torch.cat([o.flatten(2).transpose(1, 2) for o in outs], dim=1)


def dfl_expectation(logits, reg_max=16):
    p = logits.reshape(*logits.shape[:-1], 4, reg_max).softmax(dim=-1)
    return (p * torch.arange(reg_max, dtype=torch.float32,
                             device=p.device)).sum(-1)


def decode_angle(raw):
    return (torch.sigmoid(raw) - 0.25) * math.pi


def dist2rbox(ltrb, angle, anchor_pts):
    lt, rb = ltrb[..., :2], ltrb[..., 2:]
    cos, sin = torch.cos(angle), torch.sin(angle)
    xf, yf = (rb[..., 0] - lt[..., 0]) / 2.0, (rb[..., 1] - lt[..., 1]) / 2.0
    return torch.stack([xf * cos - yf * sin + anchor_pts[..., 0],
                        xf * sin + yf * cos + anchor_pts[..., 1],
                        lt[..., 0] + rb[..., 0], lt[..., 1] + rb[..., 1],
                        angle], dim=-1)


def decode(out, img_size, reg_max=16):
    """Head outputs -> (xywhr [B, A, 5] in pixels, scores [B, A, nc])."""
    box, cls = flatten_levels(out["box"]), flatten_levels(out["cls"])
    ang = flatten_levels(out["ang"])[..., 0]
    pts, strides = make_anchors(img_size, box.device)
    rb = dist2rbox(dfl_expectation(box, reg_max), decode_angle(ang), pts[None])
    return (torch.cat([rb[..., :4] * strides[None, :, None], rb[..., 4:]], -1),
            torch.sigmoid(cls))


def postprocess(rbox, scores, conf_thr, iou_thr, max_det, pre_topk):
    """Per image: single-label conf, top ``pre_topk`` (stable), class-aware
    one-shot ProbIoU NMS (suppressed boxes still suppress), top ``max_det``
    kept. Padded [B, max_det] outputs."""
    conf, cls = scores.max(dim=-1)
    pre_topk = min(pre_topk, conf.shape[-1])
    max_det = min(max_det, pre_topk)
    idx = torch.argsort(conf, dim=-1, descending=True, stable=True)[:, :pre_topk]
    cc = conf.gather(1, idx)
    rb = rbox.gather(1, idx[..., None].expand(-1, -1, 5))
    cl = cls.gather(1, idx)
    valid = cc >= conf_thr
    c8 = xywhr_to_corners8(rb)
    xy = corners8_to_xywhr(c8)
    iou = probiou(xy[..., :, None, :], xy[..., None, :, :])
    n = torch.arange(cc.shape[-1], device=cc.device)
    key = torch.where(valid, cc, torch.full_like(cc, -torch.inf))
    ki, kj = key[..., :, None], key[..., None, :]
    higher = (ki > kj) | ((ki == kj) & (n[:, None] < n[None, :]))
    sup = ((iou >= iou_thr) & (cl[..., :, None] == cl[..., None, :])
           & higher & valid[..., :, None])
    keep = valid & ~sup.any(dim=-2)
    k2 = torch.where(keep, cc, torch.full_like(cc, -torch.inf))
    sel = torch.argsort(k2, dim=-1, descending=True, stable=True)[:, :max_det]
    return {"corners8": c8.gather(1, sel[..., None].expand(-1, -1, 8)),
            "cls": cl.gather(1, sel), "conf": cc.gather(1, sel),
            "valid": keep.gather(1, sel)}
