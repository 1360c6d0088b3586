"""Rotated task-aligned label assigner, the port of the JAX package's
``train/assigner.py``: each GT scores the anchors by
align = cls_score^alpha * ProbIoU^beta among those whose centers lie inside
the rotated GT box, takes the top k, an anchor claimed by several GTs keeps
the one of highest IoU, and the per-anchor targets are the GT's label,
rotated box and align-normalized score. GTs are padded to a fixed count with
a validity mask."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import geometry as G


def candidates_in_rotated_gts(anchor_pts: torch.Tensor,
                              gt_xywhr: torch.Tensor) -> torch.Tensor:
    """Anchor centers [A, 2] x rotated GT boxes [..., M, 5] -> [..., M, A]
    bool: the center lies inside the rectangle. With corners a, b (= a +
    h-edge), d (= a + w-edge), p is inside iff 0 <= ap.ab <= ab.ab and
    0 <= ap.ad <= ad.ad."""
    pts = G.xywhr_to_corners8(gt_xywhr).reshape(*gt_xywhr.shape[:-1], 4, 2)
    a, b, d = pts[..., 1, :], pts[..., 0, :], pts[..., 2, :]
    ab, ad = b - a, d - a                              # [..., M, 2]
    ap = anchor_pts - a[..., None, :]                  # [..., M, A, 2]
    dot_ab = (ap * ab[..., None, :]).sum(-1)
    dot_ad = (ap * ad[..., None, :]).sum(-1)
    nab = (ab * ab).sum(-1)[..., None]
    nad = (ad * ad).sum(-1)[..., None]
    return (dot_ab >= 0) & (dot_ab <= nab) & (dot_ad >= 0) & (dot_ad <= nad)


@torch.no_grad()
def assign(pd_scores: torch.Tensor, pd_bboxes: torch.Tensor,
           anchor_pts: torch.Tensor, gt_labels: torch.Tensor,
           gt_bboxes: torch.Tensor, gt_mask: torch.Tensor, topk: int = 10,
           alpha: float = 0.5, beta: float = 6.0, nc: int = 12,
           eps: float = 1e-9) -> dict:
    """pd_scores [B, A, nc] sigmoid scores, pd_bboxes [B, A, 5] xywhr,
    anchor_pts [A, 2] (same units), gt_labels [B, M] int, gt_bboxes
    [B, M, 5], gt_mask [B, M] bool. Returns labels [B, A], bboxes
    [B, A, 5], scores [B, A, nc] and fg [B, A]."""
    B, M = gt_labels.shape
    labels = gt_labels.long()
    in_gts = candidates_in_rotated_gts(anchor_pts, gt_bboxes)   # [B, M, A]
    iou = torch.clamp_min(
        G.probiou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :]), 0.0)
    cls_score = torch.gather(
        pd_scores, 2, labels[:, None, :].expand(-1, pd_scores.shape[1], -1)
    ).transpose(1, 2)                                            # [B, M, A]
    align = cls_score ** alpha * iou ** beta

    cand = in_gts & gt_mask[:, :, None]
    metric = torch.where(cand, align, torch.zeros_like(align))
    kth = torch.topk(metric, topk, dim=-1).values[..., -1:]      # [B, M, 1]
    topk_mask = cand & (metric >= torch.clamp_min(kth, eps)) & (metric > 0)

    # an anchor claimed by several GTs keeps the one of highest IoU
    claimed = topk_mask.sum(1)                                   # [B, A]
    iou_masked = torch.where(topk_mask, iou, torch.full_like(iou, -1.0))
    best_gt = iou_masked.argmax(1)                               # [B, A]
    onehot_best = F.one_hot(best_gt, M).transpose(1, 2).bool()   # [B, M, A]
    final_mask = torch.where(claimed[:, None, :] > 1,
                             topk_mask & onehot_best, topk_mask)

    fg = final_mask.any(1)                                       # [B, A]
    gt_idx = final_mask.to(torch.uint8).argmax(1)                # [B, A]
    t_labels = torch.gather(labels, 1, gt_idx)
    t_bboxes = torch.gather(gt_bboxes, 1, gt_idx[..., None].expand(-1, -1, 5))

    # normalized score targets: align * (max_iou / max_align) per GT
    zero = torch.zeros_like(align)
    metric_f = torch.where(final_mask, align, zero)
    iou_f = torch.where(final_mask, iou, zero)
    max_align = metric_f.amax(dim=2, keepdim=True)
    max_iou = iou_f.amax(dim=2, keepdim=True)
    score_val = (metric_f * max_iou / (max_align + eps)).amax(dim=1)  # [B, A]
    t_scores = F.one_hot(t_labels, nc).to(align.dtype) * score_val[..., None]
    t_scores = torch.where(fg[..., None], t_scores, torch.zeros_like(t_scores))
    return {"labels": torch.where(fg, t_labels, torch.zeros_like(t_labels)),
            "bboxes": t_bboxes, "scores": t_scores, "fg": fg}
