"""Rotated RTMDet (mmrotate 1.x ``rotated_rtmdet_l-3x-dota.py``): the port's
``TiledDetector`` built through its checkpoint path on the configuration's
seeded checkpoint, the plain reference model loaded from the same file
(``reference/rtmdet_r.py``, which writes it and imports nothing of the
program), the reference's tile input (BGR, less the mean, over the std)
and decode (offset-0 anchors, ``exp(reg) * stride``, le90, sigmoid), the
reference's FLOPs of one tile, and the work of its depthwise ConvBNs."""

from __future__ import annotations

import functools

import torch

from obbbench.reference import rtmdet_r as RR

reference_input = RR.reference_input
reference_decode = RR.decode


def program_detector(cell, device):
    """The program's ``TiledDetector`` on the seeded checkpoint: the
    checkpoint's ``extra["arch"]`` picks RTMDet-R in the program, every
    knob the configuration states is passed through."""
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)
    from oriented_object_detection_tpu_torch.models import archs

    cfg = cell.config
    if "rtmdet_r" not in archs.ARCHS:
        raise SystemExit("the program has no RTMDet-R")
    path = RR.checkpoint(cfg, cell.root)
    triples = [(s["tile_size"], s["overlap"], path) for s in cfg["scales"]]
    fields = {k: cfg[k] for k in (
        "calculate_metrics", "conf_thr_metrics", "conf_thr_predict",
        "engine_nms_iou", "merge_iou", "apply_border_filter", "margin_128",
        "margin_416", "max_det_per_tile", "pre_topk", "compute_dtype")}
    return build_detector(triples, channels=cfg["channels"],
                          model_scale=cfg["model_scale"], device=device,
                          **fields)


def reference_models(cfg: dict, root: str, device,
                     precision: str = "float32") -> dict:
    """{tile_size: reference model in eval mode} of a configuration's
    scales, from its seeded checkpoint."""
    return RR.load_models(cfg, root, device, precision)


@functools.lru_cache(maxsize=None)
def _counts(scale: str, nc: int, tile: int) -> tuple:
    """(forward FLOPs, depthwise FLOPs, depthwise bytes) of one tile,
    counted on the reference model on the meta device: FLOPs by
    ``FlopCounterMode`` (convolutions and matrix products, two a
    multiply-add), the whole forward and each CSPNeXt block's depthwise
    ConvBN alone on its own input; bytes as each depthwise ConvBN's bf16
    input read once and output written once (2 C H W elements), and its
    kernel and folded bias."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        net = RR.RTMDetR(nc=nc, scale=scale)
    dws = [m.conv2.depthwise_conv for m in net.modules()
           if isinstance(m, RR.CSPNeXtBlock)]
    inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: inputs.append((mod, tuple(args[0].shape))))
        for m in dws]
    x = torch.zeros(1, 3, tile, tile, device="meta")
    with FlopCounterMode(display=False) as total, torch.no_grad():
        net(x)
    for h in hooks:
        h.remove()
    flops = nbytes = 0.0
    for mod, shape in inputs:
        with FlopCounterMode(display=False) as one, torch.no_grad():
            mod(torch.zeros(shape, device="meta"))
        flops += one.get_total_flops()
        c, n = shape[1], shape[2] * shape[3]
        nbytes += 2.0 * (2 * c * n + mod.conv.weight.numel() + c)
    return float(total.get_total_flops()), flops, nbytes


def forward_flops(cfg: dict, tile: int) -> float:
    """FLOPs of one forward of one ``tile`` x ``tile`` input."""
    return _counts(cfg["model_scale"], cfg["nc"], tile)[0]


def depthwise_work(cfg: dict, tile: int) -> tuple:
    """(FLOPs, bytes) of the CSPNeXt blocks' depthwise ConvBNs of one
    tile's forward."""
    return _counts(cfg["model_scale"], cfg["nc"], tile)[1:]
