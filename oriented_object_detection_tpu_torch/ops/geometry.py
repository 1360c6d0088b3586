"""Oriented-box geometry on tensors: corner/xywhr conversion, centers, the
Strike angle and ProbIoU (the subset of the JAX package's
``ops/geometry.py`` that the detector, the loss and the loader run)."""

from __future__ import annotations

import math

import numpy as np
import torch


def xywhr_to_corners8(xywhr: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h, theta) -> [x1, y1, ..., x4, y4], ultralytics'
    `xywhr2xyxyxyxy` order: c+v1+v2, c+v1-v2, c-v1-v2, c-v1+v2 with
    v1 = w/2 along theta and v2 = h/2 across it."""
    cx, cy, w, h, r = xywhr.unbind(-1)
    cos, sin = torch.cos(r), torch.sin(r)
    v1x, v1y = w / 2 * cos, w / 2 * sin
    v2x, v2y = -h / 2 * sin, h / 2 * cos
    return torch.stack([
        cx + v1x + v2x, cy + v1y + v2y,
        cx + v1x - v2x, cy + v1y - v2y,
        cx - v1x - v2x, cy - v1y - v2y,
        cx - v1x + v2x, cy - v1y + v2y,
    ], dim=-1)


def corners8_to_xywhr(c8: torch.Tensor) -> torch.Tensor:
    """Inverse of `xywhr_to_corners8` (exact for rectangles): p0->p3 spans
    the w edge and p0->p1 the h edge."""
    pts = c8.reshape(*c8.shape[:-1], 4, 2)
    c = pts.mean(dim=-2)
    e_w = pts[..., 0, :] - pts[..., 3, :]
    e_h = pts[..., 0, :] - pts[..., 1, :]
    w = torch.linalg.vector_norm(e_w, dim=-1)
    h = torch.linalg.vector_norm(e_h, dim=-1)
    theta = torch.atan2(e_w[..., 1], e_w[..., 0])
    return torch.stack([c[..., 0], c[..., 1], w, h, theta], dim=-1)


def corners8_to_xywhr_np(c8) -> np.ndarray:
    """Numpy float64 twin of `corners8_to_xywhr` for the loader's host label
    math: [N, 8] -> [N, 5]."""
    pts = np.asarray(c8, np.float64).reshape(-1, 4, 2)
    c = pts.mean(axis=1)
    e_w = pts[:, 0] - pts[:, 3]
    e_h = pts[:, 0] - pts[:, 1]
    w = np.linalg.norm(e_w, axis=-1)
    h = np.linalg.norm(e_h, axis=-1)
    theta = np.arctan2(e_w[:, 1], e_w[:, 0])
    return np.stack([c[:, 0], c[:, 1], w, h, theta], axis=-1)


def box_center(c8: torch.Tensor) -> torch.Tensor:
    """4-corner centroid (`Detect_OBB.py:159-165`): [..., 8] -> [..., 2]."""
    return c8.reshape(*c8.shape[:-1], 4, 2).mean(dim=-2)


def strike_angle(c8: torch.Tensor) -> torch.Tensor:
    """Strike angle in degrees folded to [0, 180] (`Detect_OBB.py:135-142`):
    atan2(x4-x1, y4-y1) in degrees, then 180-a if a > 0 else |a|."""
    ang = torch.atan2(c8[..., 6] - c8[..., 0], c8[..., 7] - c8[..., 1]) \
        * (180.0 / math.pi)
    return torch.where(ang > 0, 180.0 - ang, ang.abs())


def _xywhr_to_gaussian(xywhr: torch.Tensor):
    """Rotated box -> 2D Gaussian covariance terms (a, b, c)."""
    w, h, r = xywhr[..., 2], xywhr[..., 3], xywhr[..., 4]
    cos, sin = torch.cos(r), torch.sin(r)
    w2, h2 = (w * w) / 12.0, (h * h) / 12.0
    a = w2 * cos * cos + h2 * sin * sin
    b = w2 * sin * sin + h2 * cos * cos
    c = (w2 - h2) * cos * sin
    return a, b, c


def probiou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7
            ) -> torch.Tensor:
    """ProbIoU (1 - Hellinger distance of the box Gaussians) between
    broadcastable xywhr boxes [..., 5]."""
    x1, y1 = box1[..., 0], box1[..., 1]
    x2, y2 = box2[..., 0], box2[..., 1]
    a1, b1, c1 = _xywhr_to_gaussian(box1)
    a2, b2, c2 = _xywhr_to_gaussian(box2)
    dx, dy = x2 - x1, y2 - y1
    sa, sb, sc = a1 + a2, b1 + b2, c1 + c2
    denom = torch.clamp_min(sa * sb - sc * sc, eps)
    t1 = ((sa * dy * dy + sb * dx * dx) / denom) * 0.25
    t2 = ((sc * dx * dy * -2.0) / denom) * 0.25
    det1 = torch.clamp_min(a1 * b1 - c1 * c1, 0.0)
    det2 = torch.clamp_min(a2 * b2 - c2 * c2, 0.0)
    # where-guarded sqrt: degenerate (padded) boxes give a zero product,
    # and an unguarded sqrt there has an infinite gradient
    prod = det1 * det2
    safe = torch.where(prod > 0, prod, torch.ones_like(prod))
    root = torch.where(prod > 0, torch.sqrt(safe), torch.zeros_like(prod))
    t3 = 0.5 * torch.log(denom / (4.0 * root + eps) + eps)
    bd = torch.clamp(t1 + t2 + t3, eps, 100.0)
    hd = torch.sqrt(1.0 - torch.exp(-bd) + eps)
    return 1.0 - hd


def probiou_matrix(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Pairwise ProbIoU: b1 [N, 5], b2 [M, 5] -> [N, M]."""
    return probiou(b1[:, None, :], b2[None, :, :])
