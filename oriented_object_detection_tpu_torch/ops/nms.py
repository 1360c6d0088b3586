"""The engine's fixed-shape rotated NMS (one-shot ProbIoU rule) and the
stable top-k compaction of its result, over any leading batch dims."""

from __future__ import annotations

import torch

from . import geometry as G


def nms_keep_mask_oneshot(corners8: torch.Tensor, cls_id: torch.Tensor,
                          conf: torch.Tensor, valid: torch.Tensor,
                          iou_thr: float) -> torch.Tensor:
    """ultralytics' `nms_rotated` rule: keep i iff no higher-ranked
    same-class valid box overlaps it with ProbIoU >= thr (suppressed boxes
    still suppress). Rank is conf, ties broken by the lower index.
    [..., N, 8], [..., N], [..., N], [..., N] -> keep mask [..., N]."""
    xywhr = G.corners8_to_xywhr(corners8)
    iou = G.probiou(xywhr[..., :, None, :], xywhr[..., None, :, :])
    same = cls_id[..., :, None] == cls_id[..., None, :]
    idx = torch.arange(conf.shape[-1], device=conf.device)
    key = torch.where(valid, conf, torch.full_like(conf, -torch.inf))
    ki, kj = key[..., :, None], key[..., None, :]
    higher = (ki > kj) | ((ki == kj) & (idx[:, None] < idx[None, :]))
    sup = (iou >= iou_thr) & same & higher & valid[..., :, None]
    return valid & ~sup.any(dim=-2)


def compact_topk(conf: torch.Tensor, keep: torch.Tensor, max_out: int):
    """Indices of the top-`max_out` kept boxes by conf (descending, ties in
    index order) and their validity: (indices [..., max_out],
    valid [..., max_out])."""
    key = torch.where(keep, conf, torch.full_like(conf, -torch.inf))
    order = torch.argsort(key, dim=-1, descending=True, stable=True)
    order = order[..., :max_out]
    return order, keep.gather(-1, order)
