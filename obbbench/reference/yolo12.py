"""Plain float32 YOLO12-OBB (ultralytics ``cfg/models/12/yolo12-obb.yaml``,
arXiv:2502.12524) and the rule of its seeded weights, written with plain
torch and numpy and importing nothing of the program.

The model reuses YOLO11's blocks of ``model.py`` (``ConvBN``, ``C3k``,
``C3k2``, ``OBBHead``, ``upsample2x``, the fp8 and bf16 rounding) and adds
area attention as ultralytics writes it: the qkv channels viewed as
[tokens, heads, 3 * 32], the tokens cut into ``area`` runs of rows, an
explicit ``softmax(q k^T / sqrt(32))`` a head and area, and
``proj(out + pe(v))``. ``set_precision`` rounds the convolutions and the
attention products as ``model.py`` does for YOLO11's attention.

The weights (no trained YOLO12 weights are committed): every conv kernel
lecun normal truncated at two standard deviations, the BatchNorm scale,
bias, mean and variance drawn from the seed (so folding them is not the
identity), ``gamma`` drawn around 1 (ultralytics starts it at 0.01, which
would leave the attention stages all but unused), the engine's head
biases, then the class biases shifted so that ``density`` of the anchors
of a few noise images score 0.45 (the program's ``models/calibrate.py``
rule, on smaller images). ``checkpoint`` writes them once a seed in the
program's checkpoint format (a pickle of flax-named numpy trees, conv
kernels HWIO, ``extra["arch"] = "yolo12"``) under ``.obbbench_cache/``;
``load_models`` reads that file back with ``ckpt.load`` and the key
mapping below, so the program and the reference run one file.
"""

from __future__ import annotations

import hashlib
import math
import os
import pickle

import numpy as np
import torch
import torch.nn as nn

from . import ckpt
from .model import (ROUND, SCALES, STRIDES, BatchNorm, C3k, C3k2, Conv2d,
                    ConvBN, OBBHead, _ch, decode, upsample2x)

HEAD = 21
# flax's truncated normal in [-2, 2] has this standard deviation
TRUNC_STD = 0.87962566103423978


class AAttn(nn.Module):
    precision = "float32"

    def __init__(self, dim, num_heads, area=1):
        super().__init__()
        self.area = area
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        c = self.head_dim * num_heads
        self.qkv = ConvBN(dim, 3 * c, 1, act=False)
        self.proj = ConvBN(c, dim, 1, act=False)
        self.pe = ConvBN(c, dim, 7, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        qkv = self.qkv(x).flatten(2).transpose(1, 2)
        if self.area > 1:
            qkv = qkv.reshape(B * self.area, N // self.area, C * 3)
            B, N, _ = qkv.shape
        q, k, v = qkv.view(B, N, self.num_heads, self.head_dim * 3).permute(
            0, 2, 3, 1).split([self.head_dim] * 3, dim=2)
        r = ROUND.get(self.precision, lambda t: t)
        attn = (torch.matmul(r(q.transpose(-2, -1)), r(k))
                * self.head_dim ** -0.5).softmax(dim=-1)
        out = torch.matmul(r(v), r(attn.transpose(-2, -1)))
        out, v = out.permute(0, 3, 1, 2), v.permute(0, 3, 1, 2)
        if self.area > 1:
            out = out.reshape(B // self.area, N * self.area, C)
            v = v.reshape(B // self.area, N * self.area, C)
            B = B // self.area
        out = out.reshape(B, H, W, C).permute(0, 3, 1, 2)
        v = v.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return self.proj(out + self.pe(v))


class ABlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=1.2, area=1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(ConvBN(dim, hidden, 1),
                                 ConvBN(hidden, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    def __init__(self, c1, c2, n=1, a2=True, area=1, residual=False,
                 mlp_ratio=2.0, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        assert c_ % 32 == 0
        self.cv1 = ConvBN(c1, c_, 1)
        self.cv2 = ConvBN((1 + n) * c_, c2, 1)
        self.gamma = (nn.Parameter(0.01 * torch.ones(c2))
                      if a2 and residual else None)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, c_ // 32, mlp_ratio, area)
                            for _ in range(2)))
            if a2 else C3k(c_, c_, 2, True) for _ in range(n))

    def forward(self, x):
        y = [self.cv1(x)]
        y.extend(m(y[-1]) for m in self.m)
        y = self.cv2(torch.cat(y, 1))
        if self.gamma is not None:
            return x + self.gamma.view(-1, len(self.gamma), 1, 1) * y
        return y


class YOLO12OBB(nn.Module):
    """forward(x [B, C, H, W] float32 in 0..1) -> per-level raw head
    outputs {"box", "cls", "ang"}."""

    def __init__(self, nc=12, scale="x", in_channels=3, reg_max=16, ne=1):
        super().__init__()
        d, w, mc = SCALES[scale]
        ch = lambda c: _ch(c, w, mc)
        rep = lambda n: max(round(n * d), 1)
        c3k = scale in ("m", "l", "x")
        res, mlp = (True, 1.2) if scale in ("l", "x") else (False, 2.0)
        c64, c128, c256, c512, c1024 = (ch(c) for c in
                                        (64, 128, 256, 512, 1024))
        layers = {
            0: ConvBN(in_channels, c64, 3, 2), 1: ConvBN(c64, c128, 3, 2),
            2: C3k2(c128, c256, rep(2), c3k, e=0.25),
            3: ConvBN(c256, c256, 3, 2),
            4: C3k2(c256, c512, rep(2), c3k, e=0.25),
            5: ConvBN(c512, c512, 3, 2),
            6: A2C2f(c512, c512, rep(4), True, 4, res, mlp),
            7: ConvBN(c512, c1024, 3, 2),
            8: A2C2f(c1024, c1024, rep(4), True, 1, res, mlp),
            11: A2C2f(c1024 + c512, c512, rep(2), False, -1, res, mlp),
            14: A2C2f(c512 + c512, c256, rep(2), False, -1, res, mlp),
            15: ConvBN(c256, c256, 3, 2),
            17: A2C2f(c256 + c512, c512, rep(2), False, -1, res, mlp),
            18: ConvBN(c512, c512, 3, 2),
            20: C3k2(c512 + c1024, c1024, rep(2), True),
            HEAD: OBBHead(nc, (c256, c512, c1024), reg_max, ne,
                          c2=max(16, c256 // 4, reg_max * 4),
                          c3=max(c256, min(nc, 100)), c4=max(c256 // 4, ne)),
        }
        self.model = nn.ModuleDict({str(i): m for i, m in layers.items()})

    def set_precision(self, precision: str) -> "YOLO12OBB":
        if precision not in ("float32", "fp8", "bf16"):
            raise ValueError(f"precision {precision!r}")
        for m in self.modules():
            if isinstance(m, (Conv2d, AAttn)):
                m.precision = precision
        return self

    def forward(self, x):
        L = self.model
        x = L["3"](L["2"](L["1"](L["0"](x))))
        p3b = L["4"](x)
        p4b = L["6"](L["5"](p3b))
        p5b = L["8"](L["7"](p4b))
        n11 = L["11"](torch.cat([upsample2x(p5b), p4b], 1))
        p3 = L["14"](torch.cat([upsample2x(n11), p3b], 1))
        p4 = L["17"](torch.cat([L["15"](p3), n11], 1))
        p5 = L["20"](torch.cat([L["18"](p4), p5b], 1))
        return L[str(HEAD)]((p3, p4, p5))


def build(state: dict, scale: str, nc: int = 12, channels: int = 3,
          device="cpu") -> YOLO12OBB:
    """The model with ``state`` (ultralytics keys) loaded strictly."""
    model = YOLO12OBB(nc=nc, scale=scale, in_channels=channels)
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
# Checkpoint keys: ultralytics key <-> (collection, flax path)
# ---------------------------------------------------------------------------

BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var")}


def flax_path(key: str) -> tuple:
    """(collection, path) of an ultralytics key in the program's
    checkpoint trees: ``model.<i>`` is ``l<i>``, ``m.<j>`` is ``m_<j>``; in
    the head, ``cv<b>.<level>.<stage>[.<sub>]`` is one name
    ``cv<b>_<level>_<stage>[_<sub>]``, the depthwise ConvBN of ``cv3``
    under ``dw``; a conv's weight is ``kernel``, BatchNorm's leaves are
    ``scale``, ``bias``, ``mean`` and ``var``; ``gamma`` keeps its name."""
    parts = key.split(".")
    layer, rest, leaf = parts[1], parts[2:-1], parts[-1]
    path = [f"l{layer}"]
    if layer == str(HEAD):
        sub = rest[3] if len(rest) > 3 and rest[3].isdigit() else None
        path.append("_".join(rest[:3] + ([sub] if sub else [])))
        if rest[0] == "cv3" and sub == "0":
            path.append("dw")
        rest = rest[4 if sub else 3:]
    i = 0
    while i < len(rest):
        if rest[i] == "m" and i + 1 < len(rest) and rest[i + 1].isdigit():
            path.append(f"m_{rest[i + 1]}")
            i += 2
        else:
            path.append(rest[i])
            i += 1
    if path[-1] == "bn":
        coll, name = BN_LEAF[leaf]
        return coll, path + [name]
    return "params", path + [{"weight": "kernel"}.get(leaf, leaf)]


def to_trees(state: dict) -> dict:
    """{'params', 'batch_stats'} trees of an ultralytics-keyed float32
    state (conv kernels OIHW -> HWIO)."""
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
    """The ultralytics-keyed state of ``trees`` for the model keys
    ``keys``; a key with no leaf, or a leaf with no key, raises."""
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

def _lecun(rng, shape) -> np.ndarray:
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2.0
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2.0
    fan_in = int(np.prod(shape[1:]))
    return (z / math.sqrt(fan_in) / TRUNC_STD).astype(np.float32)


def calib_images(channels: int, w: dict) -> torch.Tensor:
    """The calibration input: ``w["calib_images"]`` seeded synthetic maps
    of ``w["calib_size"]`` pixels a side (``harness/synth.py``, seed
    ``w["calib_seed"]``), [B, C, H, W] float32 in 0..1 as the tiles enter
    the network (BGR flipped to RGB)."""
    from ..harness import synth

    t = w["calib_size"]
    maps = np.stack([synth.synthetic_map(w["calib_seed"], i, t, t,
                                         torch.device("cpu"))[0]
                     for i in range(w["calib_images"])])
    x = torch.from_numpy(maps[..., ::-1].copy()).permute(0, 3, 1, 2)
    return x.to(torch.float32) / 255.0


def draw_state(scale: str, nc: int, channels: int, w: dict) -> dict:
    """The seeded draws of a model (``w``: the configuration's
    ``weights``), in the model's key order. BatchNorm's running mean is
    drawn in units of the layer's root mean square and its variance as a
    factor of the layer's mean square, which ``set_statistics`` reads off
    the calibration maps."""
    model = YOLO12OBB(nc=nc, scale=scale, in_channels=channels)
    rng = np.random.default_rng(w["seed"])
    lo, hi = w["bn_var"]
    out = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith("bn.weight"):
            a = w["bn_gain"] * (1.0 + w["bn_scale"] * rng.uniform(
                -1.0, 1.0, shape))
            if key.endswith("attn.qkv.bn.weight"):
                a = np.where(qk_channels(shape[0]), a * w["qk_scale"], a)
        elif key.endswith(("bn.bias", "bn.running_mean")):
            a = w["bn_shift"] * rng.uniform(-1.0, 1.0, shape)
        elif key.endswith("bn.running_var"):
            a = np.exp(rng.uniform(math.log(lo), math.log(hi), shape))
        elif key.endswith("gamma"):
            a = 1.0 + w["gamma"] * rng.uniform(-1.0, 1.0, shape)
        elif key.endswith("weight"):
            a = _lecun(rng, shape)
        else:                                 # the head's plain conv biases
            a = np.zeros(shape)
        out[key] = np.asarray(a, np.float32)
    h = f"model.{HEAD}"
    for lvl, s in enumerate(STRIDES):
        out[f"{h}.cv2.{lvl}.2.bias"][:] = 1.0
        out[f"{h}.cv3.{lvl}.2.bias"][:] = math.log(5.0 / nc / (640.0 / s)
                                                   ** 2)
    return out


def qk_channels(c: int) -> np.ndarray:
    """Which of a qkv conv's ``c`` output channels are q or k: the first
    two thirds of each head's 3 x 32."""
    return np.arange(c) % (3 * 32) < 2 * 32


@torch.no_grad()
def set_statistics(draws: dict, scale: str, nc: int, channels: int,
                   w: dict) -> dict:
    """The state with each BatchNorm's running statistics read off its
    input over the calibration maps (``calib_images``), layer after layer
    in the forward's order: the variance is the drawn factor times the
    layer's mean square (one number for all its channels), the mean the
    drawn offset times the layer's root mean square; the q and k channels
    of each qkv conv also subtract their own mean, so that the attention's
    logits carry the tokens' content rather than one constant. With
    ``bn_gain`` well below 1 every SiLU runs near its linear part: random
    kernels with unit statistics let the 16 residual attention blocks
    double the signal each, and layer statistics a channel make a random
    network so sensitive that bf16 rounding alone moves most boxes."""
    model = build(draws, scale, nc, channels).eval()

    def from_input(bn, args):
        x = args[0]
        ms = (x * x).mean()
        mean = bn.running_mean * ms.sqrt()
        if hasattr(bn, "qk"):
            mean = mean + torch.where(bn.qk, x.mean(dim=(0, 2, 3)), 0.0)
        bn.running_mean.copy_(mean)
        bn.running_var.mul_(ms)

    for name, m in model.named_modules():
        if name.endswith("attn.qkv.bn"):
            m.qk = torch.from_numpy(qk_channels(m.num_features))
    hooks = [m.register_forward_pre_hook(from_input)
             for m in model.modules() if isinstance(m, BatchNorm)]
    model(calib_images(channels, w))
    for h in hooks:
        h.remove()
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if k in draws}


@torch.no_grad()
def density_shift(state: dict, scale: str, nc: int, channels: int,
                  w: dict) -> float:
    """The class-bias offset that puts ``w["density"]`` of the anchors of
    the calibration images at conf 0.45 (float32, on the CPU)."""
    model = build(state, scale, nc, channels).eval()
    scores = decode(model(calib_images(channels, w)), w["calib_size"])[1]
    s = np.clip(scores.numpy().astype(np.float64).reshape(-1), 1e-9,
                1 - 1e-9)
    return float(np.log(0.45 / 0.55)) - float(
        np.quantile(np.log(s / (1 - s)), 1.0 - w["density"]))


def make_state(scale: str, nc: int, channels: int, w: dict) -> dict:
    state = set_statistics(draw_state(scale, nc, channels, w), scale, nc,
                           channels, w)
    offset = np.float32(density_shift(state, scale, nc, channels, w))
    for lvl in range(len(STRIDES)):
        state[f"model.{HEAD}.cv3.{lvl}.2.bias"] += offset
    return state


def checkpoint(cfg: dict, root: str) -> str:
    """The path of the configuration's seeded checkpoint under
    ``<root>/.obbbench_cache/``, written if it is not there (to a
    temporary name, then renamed). The name holds the weights' settings
    and a digest of this file and ``model.py``."""
    w = cfg["weights"]
    here = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256(repr(sorted(w.items())).encode())
    for f in ("yolo12.py", "model.py"):
        with open(os.path.join(here, f), "rb") as fh:
            h.update(fh.read())
    name = (f"yolo12_{cfg['model_scale']}_c{cfg['channels']}_nc{cfg['nc']}"
            f"_t{cfg['scales'][0]['tile_size']}"
            f"_seed{w['seed']}_{h.hexdigest()[:12]}.ckpt")
    path = os.path.join(root, ".obbbench_cache", name)
    if os.path.exists(path):
        return path
    state = make_state(cfg["model_scale"], cfg["nc"], cfg["channels"], w)
    ck = {"step": 0, **to_trees(state), "ema_params": None,
          "opt_state": None,
          "extra": {"arch": "yolo12", "model_scale": cfg["model_scale"],
                    "channels": cfg["channels"],
                    "tile_size": cfg["scales"][0]["tile_size"]}}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(ck, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return path


def read_state(path: str, scale: str, nc: int, channels: int) -> dict:
    """The ultralytics-keyed float32 state of a YOLO12 checkpoint."""
    keys = [k for k in YOLO12OBB(nc=nc, scale=scale,
                                 in_channels=channels).state_dict()
            if not k.endswith("num_batches_tracked")]
    return from_trees(ckpt.load(path), keys)


def load_models(cfg: dict, root: str, device, precision: str = "float32"
                ) -> dict:
    """{tile_size: reference model in eval mode} of a configuration's
    scales, from its seeded checkpoint."""
    path = checkpoint(cfg, root)
    state = read_state(path, cfg["model_scale"], cfg["nc"], cfg["channels"])
    model = build(state, cfg["model_scale"], cfg["nc"], cfg["channels"],
                  device).eval().set_precision(precision)
    return {sc["tile_size"]: model for sc in cfg["scales"]}
