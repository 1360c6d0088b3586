"""YOLO12-OBB (``ultralytics/cfg/models/12/yolo12-obb.yaml``): the port's
``TiledDetector`` built through its checkpoint path on the configuration's
seeded checkpoint, the plain reference model loaded from the same file
(``reference/yolo12.py``, which writes it and imports nothing of the
program), the reference's FLOPs of one tile, and the area-attention
blocks' share of them."""

from __future__ import annotations

import functools

import torch

from obbbench.reference import yolo12 as RY


def program_detector(cell, device):
    """The program's ``TiledDetector`` on the seeded checkpoint: the
    checkpoint's ``extra["arch"]`` picks YOLO12-OBB in the program, every
    knob the configuration states is passed through."""
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)
    from oriented_object_detection_tpu_torch.models import archs

    cfg = cell.config
    if "yolo12" not in archs.ARCHS:
        raise SystemExit("the program has no YOLO12-OBB")
    path = RY.checkpoint(cfg, cell.root)
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
    return RY.load_models(cfg, root, device, precision)


def _meta_model(cfg: dict):
    with torch.device("meta"):
        return RY.YOLO12OBB(nc=cfg["nc"], scale=cfg["model_scale"],
                            in_channels=cfg["channels"])


@functools.lru_cache(maxsize=None)
def _counts(scale: str, nc: int, channels: int, tile: int) -> tuple:
    """(forward FLOPs, area-attention FLOPs, area-attention bytes) of one
    tile, counted on the reference model on the meta device: FLOPs by
    ``FlopCounterMode`` (convolutions and matrix products, two a
    multiply-add), the whole forward and each ``AAttn`` module alone on its
    own input; bytes as each bf16 tensor an ``AAttn`` reads or writes once
    (its input, qkv, the attention's output, the gathered v, pe's output
    and the sum, proj's output: 8 C N elements) and its weights."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = {"model_scale": scale, "nc": nc, "channels": channels}
    net = _meta_model(cfg)
    inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: inputs.append((mod, tuple(args[0].shape))))
        for m in net.modules() if isinstance(m, RY.AAttn)]
    x = torch.zeros(1, channels, tile, tile, device="meta")
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
        nbytes += 2.0 * (8 * c * n + sum(p.numel()
                                         for p in mod.parameters()))
    return float(total.get_total_flops()), flops, nbytes


def forward_flops(cfg: dict, tile: int) -> float:
    """FLOPs of one forward of one ``tile`` x ``tile`` input."""
    return _counts(cfg["model_scale"], cfg["nc"], cfg["channels"], tile)[0]


def area_attn_work(cfg: dict, tile: int) -> tuple:
    """(FLOPs, bytes) of the ``AAttn`` modules of one tile's forward."""
    return _counts(cfg["model_scale"], cfg["nc"], cfg["channels"], tile)[1:]
