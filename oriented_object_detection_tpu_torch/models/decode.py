"""Raw head outputs -> rotated boxes, and the engine's fixed-shape
postprocess: YOLO's DFL softmax expectation, angle sigmoid to
[-pi/4, 3pi/4), dist2rbox on the anchor grid (``decode_raw``), or
RTMDet-R's distance-angle decode (``decode_distance_angle``); then the
confidence filter and one-shot ProbIoU NMS shared by every architecture
(`Detect_OBB.py:228-231`, engine iou 0.7)."""

from __future__ import annotations

import math

import torch

from ..ops import geometry as G
from ..ops import nms as NMS
from .yolo11_obb import STRIDES


def make_anchors(img_size: int, device, offset: float = 0.5):
    """Anchor cell centers [A, 2] (feature-cell units) and strides [A]."""
    pts, sts = [], []
    for s in STRIDES:
        n = img_size // s
        xs = torch.arange(n, dtype=torch.float32, device=device) + offset
        gy, gx = torch.meshgrid(xs, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        sts.append(torch.full((n * n,), float(s), device=device))
    return torch.cat(pts), torch.cat(sts)


def dfl_expectation(box_logits: torch.Tensor, reg_max: int = 16
                    ) -> torch.Tensor:
    """[..., 4*reg_max] -> [..., 4] distances (softmax expectation)."""
    x = box_logits.reshape(*box_logits.shape[:-1], 4, reg_max)
    p = x.float().softmax(dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return (p * bins).sum(-1)


def decode_angle(ang_raw: torch.Tensor) -> torch.Tensor:
    """sigmoid -> [-pi/4, 3pi/4)."""
    return (torch.sigmoid(ang_raw.float()) - 0.25) * math.pi


def dist2rbox(ltrb: torch.Tensor, angle: torch.Tensor,
              anchor_pts: torch.Tensor) -> torch.Tensor:
    """Distances (l, t, r, b) + angle + anchor centers -> xywhr, in cell
    units."""
    lt, rb = ltrb[..., :2], ltrb[..., 2:]
    cos, sin = torch.cos(angle), torch.sin(angle)
    xf = (rb[..., 0] - lt[..., 0]) / 2.0
    yf = (rb[..., 1] - lt[..., 1]) / 2.0
    x = xf * cos - yf * sin + anchor_pts[..., 0]
    y = xf * sin + yf * cos + anchor_pts[..., 1]
    w = lt[..., 0] + rb[..., 0]
    h = lt[..., 1] + rb[..., 1]
    return torch.stack([x, y, w, h, angle], dim=-1)


def flatten_levels(outs) -> torch.Tensor:
    """[(B, C, Hi, Wi)...] -> [B, sum(Hi*Wi), C], row-major per level."""
    return torch.cat([o.flatten(2).transpose(1, 2) for o in outs], dim=1)


def decode_raw(out: dict, img_size: int, reg_max: int = 16):
    """Head outputs -> (xywhr [B, A, 5] in input pixels, scores [B, A, nc])."""
    box = flatten_levels(out["box"])
    cls = flatten_levels(out["cls"])
    ang = flatten_levels(out["ang"])[..., 0]
    anchor_pts, strides = make_anchors(img_size, box.device)
    rbox = dist2rbox(dfl_expectation(box, reg_max), decode_angle(ang),
                     anchor_pts[None])
    rbox = torch.cat([rbox[..., :4] * strides[None, :, None],
                      rbox[..., 4:]], dim=-1)
    return rbox, torch.sigmoid(cls.float())


def decode_distance_angle(out: dict, img_size: int):
    """RTMDet-R's head outputs {"cls", "reg", "ang"} -> (xywhr [B, A, 5] in
    input pixels, scores [B, A, nc]), as mmrotate's head and its
    ``DistanceAnglePointCoder`` decode them, in float32: the distances
    ``exp(reg) * stride``, anchors at offset 0 in pixels, the centre and
    size by ``dist2rbox``'s algebra rotated by the raw angle, then the
    angle normalised to le90, [-pi/2, pi/2); scores ``sigmoid(cls)``."""
    reg = flatten_levels(out["reg"]).float()
    cls = flatten_levels(out["cls"])
    ang = flatten_levels(out["ang"])[..., 0].float()
    anchor_pts, strides = make_anchors(img_size, reg.device, offset=0.0)
    rbox = dist2rbox(reg.exp() * strides[None, :, None], ang,
                     (anchor_pts * strides[:, None])[None])
    le90 = torch.remainder(rbox[..., 4:] + math.pi / 2, math.pi) \
        - math.pi / 2
    return torch.cat([rbox[..., :4], le90], dim=-1), torch.sigmoid(
        cls.float())


def postprocess_batch(rbox: torch.Tensor, scores: torch.Tensor,
                      conf_thr: float, iou_thr: float = 0.7,
                      max_det: int = 300, pre_topk: int = 512) -> dict:
    """Engine NMS per image: single-label conf/cls, top-`pre_topk`
    candidates (ties in index order, like ``lax.top_k``), class-aware
    one-shot ProbIoU NMS, top-`max_det` kept. Returns padded [B, max_det]
    arrays: xywhr, corners8, cls, conf, valid."""
    conf, cls = scores.max(dim=-1)
    pre_topk = min(pre_topk, conf.shape[-1])
    max_det = min(max_det, pre_topk)
    idx = torch.argsort(conf, dim=-1, descending=True, stable=True)
    idx = idx[:, :pre_topk]
    cand_conf = conf.gather(1, idx)
    cand_rb = rbox.gather(1, idx[..., None].expand(-1, -1, 5))
    cand_cl = cls.gather(1, idx)
    valid = cand_conf >= conf_thr
    c8 = G.xywhr_to_corners8(cand_rb)
    keep = NMS.nms_keep_mask_oneshot(c8, cand_cl, cand_conf, valid, iou_thr)
    sel, sel_valid = NMS.compact_topk(cand_conf, keep, max_det)
    take = lambda a: a.gather(1, sel[..., None].expand(-1, -1, a.shape[-1]))
    return {"xywhr": take(cand_rb), "corners8": take(c8),
            "cls": cand_cl.gather(1, sel), "conf": cand_conf.gather(1, sel),
            "valid": sel_valid}
