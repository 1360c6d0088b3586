"""OBB training loss, the port of the JAX package's ``train/loss.py``:
rotated task-aligned assignment, then

  * BCE on the align-normalized class score targets (sum / target score sum),
  * (1 - ProbIoU) on matched rotated boxes, weighted by the score targets,
  * DFL cross-entropy on the axis-aligned ltrb bin distribution (the angle
    enters through ProbIoU only),

with gains box 7.5, cls 0.5, dfl 1.5 and the engine's batch-size factor.
Predictions are decoded to rotated boxes in grid units and assigned in
pixels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..models import decode as D
from ..ops import geometry as G
from ..parallel import mesh as PM
from . import assigner


class LossConfig(NamedTuple):
    nc: int = 12
    reg_max: int = 16
    img_size: int = 416
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    tal_topk: int = 10
    tal_alpha: float = 0.5
    tal_beta: float = 6.0


def _dfl_loss(pred_logits: torch.Tensor, target: torch.Tensor,
              reg_max: int) -> torch.Tensor:
    """Distribution focal loss per distance: CE against the two integer bins
    around the target, linearly weighted. pred_logits [..., 4, reg_max],
    target [..., 4] in [0, reg_max - 1] -> [...] (mean over the 4)."""
    tl = torch.floor(target).long()
    tr = torch.clamp_max(tl + 1, reg_max - 1)
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_logits, dim=-1)
    ce_l = -torch.gather(logp, -1, tl[..., None])[..., 0]
    ce_r = -torch.gather(logp, -1, tr[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(-1)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's sigmoid_binary_cross_entropy: -z log s(x) - (1-z) log s(-x)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(
        -logits)


def obb_loss(raw: dict, gt_labels: torch.Tensor, gt_xywhr: torch.Tensor,
             gt_mask: torch.Tensor, cfg: LossConfig = LossConfig()):
    """raw: the model's head outputs; gt_labels [B, M] int, gt_xywhr
    [B, M, 5] in input pixels, gt_mask [B, M] bool. Returns (total, dict of
    the box, cls and dfl components and the fg count). When the global
    batch is split over processes (the world, or the data group of the
    active mesh) the batch is this process's rows of it, the normaliser is
    the global target score sum and the batch factor the global batch
    size: the returned values are this process's shares of the global
    ones, which sum to them over the data axis."""
    box_logits = D.flatten_levels(raw["box"]).float()     # [B, A, 4*reg_max]
    cls_logits = D.flatten_levels(raw["cls"]).float()     # [B, A, nc]
    ang_raw = D.flatten_levels(raw["ang"])[..., 0]        # [B, A]
    B, A = ang_raw.shape
    anchor_pts, strides = D.make_anchors(cfg.img_size, ang_raw.device)

    ltrb = D.dfl_expectation(box_logits, cfg.reg_max)      # grid units
    angle = D.decode_angle(ang_raw)
    pred_rbox_grid = D.dist2rbox(ltrb, angle, anchor_pts[None])  # [B, A, 5]

    # assignment in pixels, on detached predictions
    pred_rbox_px = torch.cat([pred_rbox_grid[..., :4]
                              * strides[None, :, None],
                              pred_rbox_grid[..., 4:]], dim=-1).detach()
    scores = torch.sigmoid(cls_logits)
    tgt = assigner.assign(
        scores.detach(), pred_rbox_px, anchor_pts * strides[:, None],
        gt_labels, gt_xywhr, gt_mask, topk=cfg.tal_topk,
        alpha=cfg.tal_alpha, beta=cfg.tal_beta, nc=cfg.nc)
    fg = tgt["fg"]                                          # [B, A]
    t_scores = tgt["scores"]                                # [B, A, nc]
    # the global batch's target score sum and size over the data axis; the
    # targets carry no gradient, so the sum is a constant
    score_sum = PM.data_sum_(t_scores.sum())
    B_global = B * PM.data_size()
    score_sum = torch.clamp_min(score_sum, 1.0)

    loss_cls = sigmoid_bce(cls_logits, t_scores).sum() / score_sum

    t_boxes_grid = torch.cat([tgt["bboxes"][..., :4] / strides[None, :, None],
                              tgt["bboxes"][..., 4:]], dim=-1)
    # Anchors outside fg get a unit box at the anchor, in the targets and in
    # the predictions: a padded (all-zero) target or a degenerate prediction
    # makes probiou NaN there, and although those lanes are masked out of
    # the loss, `where` back-propagates 0 * nan = nan through the branch it
    # did not take. The engine never sees these lanes (it gathers fg pairs).
    dummy = torch.cat([anchor_pts.expand(B, A, 2),
                       torch.ones((B, A, 2), device=fg.device),
                       torch.zeros((B, A, 1), device=fg.device)], dim=-1)
    t_boxes_grid = torch.where(fg[..., None], t_boxes_grid, dummy)
    weight = t_scores.sum(-1)                               # [B, A]
    pred_used = torch.where(fg[..., None], pred_rbox_grid, dummy)
    iou = G.probiou(pred_used, t_boxes_grid)
    zero = torch.zeros_like(weight)
    loss_box = torch.where(fg, (1.0 - iou) * weight, zero).sum() / score_sum

    half = t_boxes_grid[..., 2:4] / 2.0
    t_lt = anchor_pts[None] - (t_boxes_grid[..., :2] - half)
    t_rb = (t_boxes_grid[..., :2] + half) - anchor_pts[None]
    t_ltrb = torch.clamp(torch.cat([t_lt, t_rb], -1), 0.0,
                         cfg.reg_max - 1 - 0.01)
    dfl = _dfl_loss(box_logits.reshape(B, A, 4, cfg.reg_max), t_ltrb,
                    cfg.reg_max)
    loss_dfl = torch.where(fg, dfl * weight, zero).sum() / score_sum

    total = (cfg.box_gain * loss_box + cfg.cls_gain * loss_cls
             + cfg.dfl_gain * loss_dfl) * B_global
    return total, {"box": loss_box, "cls": loss_cls, "dfl": loss_dfl,
                   "fg_count": fg.sum()}
