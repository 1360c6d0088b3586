"""Plain float32 Rotated RTMDet (Lyu et al., arXiv:2212.07784; mmrotate 1.x
``configs/rotated_rtmdet/rotated_rtmdet_l-3x-dota.py``), its tile input and
decode, and the rule of its seeded weights, written with plain torch and
numpy and importing nothing of the program.

The modules follow mmdet's and mmrotate's definitions and names:
``ConvModule`` (conv, BatchNorm at mmcv's eps 1e-5, SiLU),
``DepthwiseSeparableConvModule``, ``CSPNeXtBlock``, ``ChannelAttention``
(an adaptive average pool, a 1x1 conv with a bias, hardsigmoid),
``CSPLayer``, ``SPPBottleneck`` (max pools of 5, 9 and 13 side by side),
the ``CSPNeXt`` P5 backbone, ``CSPNeXtPAFPN`` with its index loops, and
``RotatedRTMDetSepBNHead`` whose stacked convs are one module shared by the
three levels (``share_conv``), each level with its own BatchNorm. The
forward returns the head's raw outputs; ``decode`` applies mmrotate's
``exp() * stride`` and ``DistanceAnglePointCoder`` (anchors at offset 0 in
pixels, the offset rotated by a 2x2 matrix, le90). ``reference_input``
is mmdet's ``DetDataPreprocessor`` with ``bgr_to_rgb=False``.
``set_precision`` rounds the convolutions as ``model.py`` does (fp8 for
the control, bf16 for the look at rounding); the channel attention's gate
stays float32, as mmdet computes it outside autocast.

The weights (no trained RTMDet-R weights are in the repository): YOLO12's
rule (``yolo12.py``): every conv kernel lecun normal truncated at two
standard deviations; the BatchNorm scale, bias, mean and variance drawn
from the seed, the statistics read off a few seeded maps, so each layer
runs near SiLU's linear part; the attention's fc bias 0; ``rtm_reg``'s
bias ``reg_bias`` (``exp`` of it gives distances of about two strides);
``rtm_ang``'s 0; ``rtm_cls``'s mmdet's prior of 0.01; the three predictors'
kernels scaled to a given spread of their outputs over the anchors
(``set_spread``); last the class biases shifted so that ``density`` of
the calibration maps' anchors score 0.45 (the program's
``models/calibrate.py`` rule). ``checkpoint`` writes them once a seed in
the program's checkpoint format (a pickle of flax-named numpy trees, conv
kernels HWIO, ``extra["arch"] = "rtmdet_r"``) under ``.obbbench_cache/``;
``load_models`` reads that file back, so the program and the reference
run one file.
"""

from __future__ import annotations

import hashlib
import math
import os
import pickle

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import ckpt
from .model import Conv2d
from .yolo12 import _lecun

BN_EPS = 1e-5
STRIDES = (8, 16, 32)
MEAN = (103.53, 116.28, 123.675)
STD = (57.375, 57.12, 58.395)
# (deepen, widen) of mmdet's rtmdet_{tiny,s,m,l,x}
SCALES = {"tiny": (0.167, 0.375), "s": (0.33, 0.5), "m": (0.67, 0.75),
          "l": (1.0, 1.0), "x": (1.33, 1.25)}
# CSPNeXt's arch_settings["P5"]: in, out, blocks, add_identity, use_spp
P5 = [[64, 128, 3, True, False], [128, 256, 6, True, False],
      [256, 512, 6, True, False], [512, 1024, 3, False, True]]


class BatchNorm(nn.BatchNorm2d):
    """Inference BatchNorm on the running statistics, eps 1e-5."""

    def __init__(self, c: int):
        super().__init__(c, eps=BN_EPS)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class ConvModule(nn.Module):
    def __init__(self, c1, c2, k, stride=1, groups=1):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, stride, k // 2, groups=groups,
                           bias=False)
        self.bn = BatchNorm(c2)
        self.activate = nn.SiLU()

    def forward(self, x):
        return self.activate(self.bn(self.conv(x)))


class DepthwiseSeparableConvModule(nn.Module):
    def __init__(self, c1, c2, k):
        super().__init__()
        self.depthwise_conv = ConvModule(c1, c1, k, groups=c1)
        self.pointwise_conv = ConvModule(c1, c2, 1)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class CSPNeXtBlock(nn.Module):
    def __init__(self, c1, c2, expansion=1.0, add_identity=True,
                 kernel_size=5):
        super().__init__()
        hidden = int(c2 * expansion)
        self.conv1 = ConvModule(c1, hidden, 3)
        self.conv2 = DepthwiseSeparableConvModule(hidden, c2, kernel_size)
        self.add_identity = add_identity and c1 == c2

    def forward(self, x):
        out = self.conv2(self.conv1(x))
        return out + x if self.add_identity else out


class ChannelAttention(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Conv2d(channels, channels, 1, 1, 0, bias=True)
        self.act = nn.Hardsigmoid()

    def forward(self, x):
        return x * self.act(self.fc(self.global_avgpool(x)))


class CSPLayer(nn.Module):
    def __init__(self, c1, c2, expand_ratio=0.5, num_blocks=1,
                 add_identity=True, channel_attention=False):
        super().__init__()
        mid = int(c2 * expand_ratio)
        self.channel_attention = channel_attention
        self.main_conv = ConvModule(c1, mid, 1)
        self.short_conv = ConvModule(c1, mid, 1)
        self.final_conv = ConvModule(2 * mid, c2, 1)
        self.blocks = nn.Sequential(*[CSPNeXtBlock(mid, mid, 1.0,
                                                   add_identity)
                                      for _ in range(num_blocks)])
        if channel_attention:
            self.attention = ChannelAttention(2 * mid)

    def forward(self, x):
        x_short = self.short_conv(x)
        x_main = self.blocks(self.main_conv(x))
        x_final = torch.cat((x_main, x_short), dim=1)
        if self.channel_attention:
            x_final = self.attention(x_final)
        return self.final_conv(x_final)


class SPPBottleneck(nn.Module):
    def __init__(self, c1, c2, kernel_sizes=(5, 9, 13)):
        super().__init__()
        mid = c1 // 2
        self.conv1 = ConvModule(c1, mid, 1)
        self.poolings = nn.ModuleList([nn.MaxPool2d(ks, 1, ks // 2)
                                       for ks in kernel_sizes])
        self.conv2 = ConvModule(mid * (len(kernel_sizes) + 1), c2, 1)

    def forward(self, x):
        x = self.conv1(x)
        x = torch.cat([x] + [p(x) for p in self.poolings], dim=1)
        return self.conv2(x)


class CSPNeXt(nn.Module):
    def __init__(self, deepen, widen):
        super().__init__()
        c0 = int(P5[0][0] * widen // 2)
        self.stem = nn.Sequential(ConvModule(3, c0, 3, 2),
                                  ConvModule(c0, c0, 3),
                                  ConvModule(c0, int(P5[0][0] * widen), 3))
        self.layers = ["stem"]
        for i, (cin, cout, n, identity, spp) in enumerate(P5):
            cin, cout = int(cin * widen), int(cout * widen)
            n = max(round(n * deepen), 1)
            stage = [ConvModule(cin, cout, 3, 2)]
            if spp:
                stage.append(SPPBottleneck(cout, cout))
            stage.append(CSPLayer(cout, cout, num_blocks=n,
                                  add_identity=identity,
                                  channel_attention=True))
            self.add_module(f"stage{i + 1}", nn.Sequential(*stage))
            self.layers.append(f"stage{i + 1}")

    def forward(self, x):
        outs = []
        for i, name in enumerate(self.layers):
            x = getattr(self, name)(x)
            if i in (2, 3, 4):
                outs.append(x)
        return tuple(outs)


class CSPNeXtPAFPN(nn.Module):
    def __init__(self, in_channels, out_channels, num_csp_blocks):
        super().__init__()
        self.in_channels = in_channels
        self.upsample = nn.Upsample(scale_factor=2, mode="nearest")
        self.reduce_layers = nn.ModuleList()
        self.top_down_blocks = nn.ModuleList()
        for idx in range(len(in_channels) - 1, 0, -1):
            self.reduce_layers.append(ConvModule(in_channels[idx],
                                                 in_channels[idx - 1], 1))
            self.top_down_blocks.append(CSPLayer(
                in_channels[idx - 1] * 2, in_channels[idx - 1],
                num_blocks=num_csp_blocks, add_identity=False))
        self.downsamples = nn.ModuleList()
        self.bottom_up_blocks = nn.ModuleList()
        for idx in range(len(in_channels) - 1):
            self.downsamples.append(ConvModule(in_channels[idx],
                                               in_channels[idx], 3, 2))
            self.bottom_up_blocks.append(CSPLayer(
                in_channels[idx] * 2, in_channels[idx + 1],
                num_blocks=num_csp_blocks, add_identity=False))
        self.out_convs = nn.ModuleList(ConvModule(c, out_channels, 3)
                                       for c in in_channels)

    def forward(self, inputs):
        n = len(self.in_channels)
        inner_outs = [inputs[-1]]
        for idx in range(n - 1, 0, -1):
            feat_high = self.reduce_layers[n - 1 - idx](inner_outs[0])
            inner_outs[0] = feat_high
            inner_outs.insert(0, self.top_down_blocks[n - 1 - idx](
                torch.cat([self.upsample(feat_high), inputs[idx - 1]], 1)))
        outs = [inner_outs[0]]
        for idx in range(n - 1):
            down = self.downsamples[idx](outs[-1])
            outs.append(self.bottom_up_blocks[idx](
                torch.cat([down, inner_outs[idx + 1]], 1)))
        return tuple(conv(o) for conv, o in zip(self.out_convs, outs))


class RotatedRTMDetSepBNHead(nn.Module):
    def __init__(self, num_classes, in_channels, feat_channels,
                 stacked_convs=2, share_conv=True):
        super().__init__()
        self.cls_convs, self.reg_convs = nn.ModuleList(), nn.ModuleList()
        self.rtm_cls, self.rtm_reg = nn.ModuleList(), nn.ModuleList()
        self.rtm_ang = nn.ModuleList()
        for _ in STRIDES:
            cls_convs, reg_convs = nn.ModuleList(), nn.ModuleList()
            for i in range(stacked_convs):
                chn = in_channels if i == 0 else feat_channels
                cls_convs.append(ConvModule(chn, feat_channels, 3))
                reg_convs.append(ConvModule(chn, feat_channels, 3))
            self.cls_convs.append(cls_convs)
            self.reg_convs.append(reg_convs)
            self.rtm_cls.append(Conv2d(feat_channels, num_classes, 1))
            self.rtm_reg.append(Conv2d(feat_channels, 4, 1))
            self.rtm_ang.append(Conv2d(feat_channels, 1, 1))
        if share_conv:
            for n in range(len(STRIDES)):
                for i in range(stacked_convs):
                    self.cls_convs[n][i].conv = self.cls_convs[0][i].conv
                    self.reg_convs[n][i].conv = self.reg_convs[0][i].conv

    def forward(self, feats):
        out = {"cls": [], "reg": [], "ang": []}
        for idx, x in enumerate(feats):
            cls_feat, reg_feat = x, x
            for layer in self.cls_convs[idx]:
                cls_feat = layer(cls_feat)
            for layer in self.reg_convs[idx]:
                reg_feat = layer(reg_feat)
            out["cls"].append(self.rtm_cls[idx](cls_feat))
            out["reg"].append(self.rtm_reg[idx](reg_feat))
            out["ang"].append(self.rtm_ang[idx](reg_feat))
        return out


class RTMDetR(nn.Module):
    """forward(x [B, 3, H, W] float32, BGR less the mean over the std) ->
    the head's raw per-level outputs {"cls", "reg", "ang"}."""

    def __init__(self, nc=12, scale="l"):
        super().__init__()
        deepen, widen = SCALES[scale]
        chs = [int(c * widen) for c in (256, 512, 1024)]
        self.backbone = CSPNeXt(deepen, widen)
        self.neck = CSPNeXtPAFPN(chs, int(256 * widen), round(3 * deepen))
        self.bbox_head = RotatedRTMDetSepBNHead(nc, int(256 * widen),
                                                int(256 * widen))

    def set_precision(self, precision: str) -> "RTMDetR":
        if precision not in ("float32", "fp8", "bf16"):
            raise ValueError(f"precision {precision!r}")
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.precision = precision
        return self

    def forward(self, x):
        return self.bbox_head(self.neck(self.backbone(x)))


def reference_input(tiles: torch.Tensor) -> torch.Tensor:
    """uint8 BGR tiles [n, ts, ts, 3] -> float32 BGR NCHW, less the mean,
    over the std."""
    mean = torch.tensor(MEAN, device=tiles.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=tiles.device).view(1, 3, 1, 1)
    return (tiles.permute(0, 3, 1, 2).to(torch.float32) - mean) / std


def _levels(outs) -> torch.Tensor:
    return torch.cat([o.flatten(2).transpose(1, 2) for o in outs], dim=1)


def points(tile: int, device) -> tuple:
    """mmdet's ``MlvlPointGenerator`` at offset 0: [A, 2] pixel points and
    [A] strides, level by level, row-major."""
    pts, sts = [], []
    for s in STRIDES:
        n = tile // s
        xs = torch.arange(n, dtype=torch.float32, device=device) * s
        yy, xx = torch.meshgrid(xs, xs, indexing="ij")
        pts.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))
        sts.append(torch.full((n * n,), float(s), device=device))
    return torch.cat(pts), torch.cat(sts)


def decode(out: dict, tile: int) -> tuple:
    """Raw outputs -> (xywhr [B, A, 5] in tile pixels, scores [B, A, nc]):
    distances ``exp(reg) * stride``, mmrotate's ``distance2obb`` (the
    centre offset rotated by the raw angle, then the angle to le90)."""
    cls, reg, ang = (_levels(out[k]) for k in ("cls", "reg", "ang"))
    pts, strides = points(tile, reg.device)
    dist = reg.exp() * strides[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    rot = torch.cat([cos, -sin, sin, cos], dim=-1).reshape(
        *ang.shape[:-1], 2, 2)
    wh = dist[..., :2] + dist[..., 2:]
    offset = torch.matmul(rot, ((dist[..., 2:] - dist[..., :2]) / 2)
                          .unsqueeze(-1)).squeeze(-1)
    angle = (ang + math.pi / 2) % math.pi - math.pi / 2
    return torch.cat([pts + offset, wh, angle], dim=-1), cls.sigmoid()


def build(state: dict, scale: str, nc: int = 12, device="cpu") -> RTMDetR:
    """The model with ``state`` (mmrotate keys) loaded strictly."""
    model = RTMDetR(nc=nc, scale=scale)
    own = model.state_dict()
    keys = [k for k in own if not k.endswith("num_batches_tracked")]
    missing = [k for k in keys if k not in state]
    extra = [k for k in state if k not in own]
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing[:3]}, extra "
                       f"{extra[:3]}")
    with torch.no_grad():
        for k in keys:
            own[k].copy_(torch.as_tensor(state[k]))
    return model.to(device)


# ---------------------------------------------------------------------------
# Checkpoint keys: mmrotate key <-> (collection, flax path)
# ---------------------------------------------------------------------------

BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var")}


def flax_path(key: str) -> tuple:
    """(collection, path) of a mmrotate key in the program's checkpoint
    trees: the key's dotted parts, a conv's weight as ``kernel`` and
    BatchNorm's leaves as ``scale``, ``bias``, ``mean`` and ``var``."""
    *path, leaf = key.split(".")
    if path[-1] == "bn":
        coll, name = BN_LEAF[leaf]
        return coll, path + [name]
    return "params", path + [{"weight": "kernel"}.get(leaf, leaf)]


def to_trees(state: dict) -> dict:
    trees = {"params": {}, "batch_stats": {}}
    for key, a in state.items():
        coll, path = flax_path(key)
        a = np.asarray(a, np.float32)
        if path[-1] == "kernel":
            a = a.transpose(2, 3, 1, 0)
        node = trees[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return trees


def from_trees(trees: dict, keys) -> dict:
    """The mmrotate-keyed state of ``trees`` for the model keys ``keys``; a
    key with no leaf, or a leaf with no key, raises."""
    leaves = {}

    def walk(tree, path, coll):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + [k], coll)
            else:
                leaves[(coll, tuple(path + [k]))] = v

    walk(trees["params"], [], "params")
    walk(trees["batch_stats"], [], "batch_stats")
    out = {}
    for key in keys:
        coll, path = flax_path(key)
        a = np.asarray(leaves.pop((coll, tuple(path))), np.float32)
        out[key] = a.transpose(3, 2, 0, 1) if path[-1] == "kernel" else a
    if leaves:
        raise KeyError(f"checkpoint leaves with no key: {list(leaves)[:3]}")
    return out


# ---------------------------------------------------------------------------
# The seeded weights
# ---------------------------------------------------------------------------

def model_keys(scale: str, nc: int) -> list:
    return [k for k in RTMDetR(nc=nc, scale=scale).state_dict()
            if not k.endswith("num_batches_tracked")]


def calib_input(w: dict) -> torch.Tensor:
    """``w["calib_images"]`` seeded synthetic maps of ``w["calib_size"]``
    pixels a side (``harness/synth.py``, seed ``w["calib_seed"]``) as the
    network takes them (``reference_input``)."""
    from ..harness import synth

    t = w["calib_size"]
    maps = np.stack([synth.synthetic_map(w["calib_seed"], i, t, t,
                                         torch.device("cpu"))[0]
                     for i in range(w["calib_images"])])
    return reference_input(torch.from_numpy(maps))


def draw_state(scale: str, nc: int, w: dict) -> dict:
    """The seeded draws of a model (``w``: the configuration's
    ``weights``), in the model's key order; a conv shared by the head's
    levels is drawn once. BatchNorm's running mean is drawn in units of
    the layer's root mean square and its variance as a factor of the
    layer's mean square, which ``set_statistics`` reads off the
    calibration maps."""
    model = RTMDetR(nc=nc, scale=scale)
    rng = np.random.default_rng(w["seed"])
    lo, hi = w["bn_var"]
    out, drawn = {}, {}
    for key, t in model.state_dict(keep_vars=True).items():
        shape = tuple(t.shape)
        if key.endswith("num_batches_tracked"):
            continue
        if id(t) in drawn:                 # the head's shared convs
            out[key] = drawn[id(t)]
            continue
        if key.endswith("bn.weight"):
            a = w["bn_gain"] * (1.0 + w["bn_scale"] * rng.uniform(
                -1.0, 1.0, shape))
        elif key.endswith(("bn.bias", "bn.running_mean")):
            a = w["bn_shift"] * rng.uniform(-1.0, 1.0, shape)
        elif key.endswith("bn.running_var"):
            a = np.exp(rng.uniform(math.log(lo), math.log(hi), shape))
        elif key.endswith("weight"):
            a = _lecun(rng, shape)
        elif ".rtm_reg." in key:
            a = np.full(shape, w["reg_bias"])
        elif ".rtm_cls." in key:            # mmdet's bias_init_with_prob
            a = np.full(shape, -math.log((1 - 0.01) / 0.01))
        else:                               # rtm_ang, the attention's fc
            a = np.zeros(shape)
        out[key] = drawn[id(t)] = np.asarray(a, np.float32)
    return out


@torch.no_grad()
def set_statistics(draws: dict, scale: str, nc: int, w: dict) -> dict:
    """The state with each BatchNorm's running statistics read off its
    input over the calibration maps, layer after layer in the forward's
    order: the variance is the drawn factor times the layer's mean square
    (one number for all its channels), the mean the drawn offset times
    the layer's root mean square. With ``bn_gain`` well below 1 every SiLU
    runs near its linear part and the 18 residual blocks of the backbone
    do not grow the signal, so bf16 rounding moves few boxes."""
    model = build(draws, scale, nc).eval()

    def from_input(bn, args):
        ms = (args[0] * args[0]).mean()
        bn.running_mean.mul_(ms.sqrt())
        bn.running_var.mul_(ms)

    hooks = [m.register_forward_pre_hook(from_input)
             for m in model.modules() if isinstance(m, BatchNorm)]
    model(calib_input(w))
    for h in hooks:
        h.remove()
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if k in draws}


@torch.no_grad()
def density_shift(state: dict, scale: str, nc: int, w: dict) -> float:
    """The class-bias offset that puts ``w["density"]`` of the anchors of
    the calibration maps at conf 0.45 (float32, on the CPU)."""
    model = build(state, scale, nc).eval()
    scores = decode(model(calib_input(w)), w["calib_size"])[1]
    s = np.clip(scores.numpy().astype(np.float64).reshape(-1), 1e-9,
                1 - 1e-9)
    return float(np.log(0.45 / 0.55)) - float(
        np.quantile(np.log(s / (1 - s)), 1.0 - w["density"]))


@torch.no_grad()
def set_spread(state: dict, scale: str, nc: int, w: dict) -> dict:
    """The state with the kernels of ``rtm_cls``, ``rtm_reg`` and
    ``rtm_ang`` (of every level alike) scaled so that each output's
    standard deviation over the calibration maps' anchors, a channel,
    averages ``w["cls_std"]``, ``w["reg_std"]`` and ``w["ang_std"]``: a
    random head's outputs hardly vary over the anchors, which would leave
    every anchor's score at one value and every box a square of one size
    at one angle."""
    out = build(state, scale, nc).eval()(calib_input(w))
    state = dict(state)
    for part in ("cls", "reg", "ang"):
        std = _levels(out[part]).std(dim=1).mean()
        gain = np.float32(w[f"{part}_std"] / float(std))
        for lvl in range(len(STRIDES)):
            key = f"bbox_head.rtm_{part}.{lvl}.weight"
            state[key] = state[key] * gain
    return state


def make_state(scale: str, nc: int, w: dict) -> dict:
    state = set_spread(set_statistics(draw_state(scale, nc, w), scale, nc,
                                      w), scale, nc, w)
    offset = np.float32(density_shift(state, scale, nc, w))
    for lvl in range(len(STRIDES)):
        state[f"bbox_head.rtm_cls.{lvl}.bias"] += offset
    return state


def checkpoint(cfg: dict, root: str) -> str:
    """The path of the configuration's seeded checkpoint under
    ``<root>/.obbbench_cache/``, written if it is not there (to a
    temporary name, then renamed). The name holds the weights' settings
    and a digest of this file and of the two it takes helpers from."""
    w = cfg["weights"]
    here = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256(repr(sorted(w.items())).encode())
    for f in ("rtmdet_r.py", "yolo12.py", "model.py"):
        with open(os.path.join(here, f), "rb") as fh:
            h.update(fh.read())
    name = (f"rtmdet_r_{cfg['model_scale']}_c3_nc{cfg['nc']}"
            f"_seed{w['seed']}_{h.hexdigest()[:12]}.ckpt")
    path = os.path.join(root, ".obbbench_cache", name)
    if os.path.exists(path):
        return path
    state = make_state(cfg["model_scale"], cfg["nc"], w)
    ck = {"step": 0, **to_trees(state), "ema_params": None,
          "opt_state": None,
          "extra": {"arch": "rtmdet_r", "model_scale": cfg["model_scale"],
                    "channels": 3}}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(ck, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return path


def read_state(path: str, scale: str, nc: int) -> dict:
    """The mmrotate-keyed float32 state of an RTMDet-R checkpoint."""
    return from_trees(ckpt.load(path), model_keys(scale, nc))


def load_models(cfg: dict, root: str, device, precision: str = "float32"
                ) -> dict:
    """{tile_size: reference model in eval mode} of a configuration's
    scales, from its seeded checkpoint."""
    state = read_state(checkpoint(cfg, root), cfg["model_scale"], cfg["nc"])
    model = build(state, cfg["model_scale"], cfg["nc"],
                  device).eval().set_precision(precision)
    return {sc["tile_size"]: model for sc in cfg["scales"]}
