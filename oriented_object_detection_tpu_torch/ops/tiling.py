"""Tiling: the inference sliding-window grid with partial edge tiles, the
batched tile gather, tile->global stitching and the border filter
(`Detect_OBB.py:156-174,216-240`); the training grid of full tiles and the
per-tile label assignment of the dataset build (`Train_OBB.py:44-108`)."""

from __future__ import annotations

import numpy as np
import torch

PAD_VALUE = 114  # ultralytics letterbox fill


def inference_tile_grid(h: int, w: int, tile_size: int, overlap: int
                        ) -> np.ndarray:
    """All inference tiles as [T, 4] int32 rows (x0, y0, crop_w, crop_h),
    steps of max(1, ts - overlap), partial edge tiles included."""
    step = max(1, tile_size - overlap)
    rows = []
    for y in range(0, h, step):
        for x in range(0, w, step):
            ch = min(y + tile_size, h) - y
            cw = min(x + tile_size, w) - x
            if ch <= 0 or cw <= 0:
                continue
            rows.append((x, y, cw, ch))
    return np.asarray(rows, dtype=np.int32).reshape(-1, 4)


def train_tile_grid(h: int, w: int, tile_size: int, overlap: int
                    ) -> np.ndarray:
    """Full tiles only, [T, 2] int32 rows (x0, y0); stride ts - overlap,
    which must be positive (`Train_OBB.py:56`)."""
    stride = tile_size - overlap
    if stride <= 0:
        raise ValueError("overlap must be < tile_size")
    rows = [(x, y) for y in range(0, h, stride) for x in range(0, w, stride)
            if y + tile_size <= h and x + tile_size <= w]
    return np.asarray(rows, dtype=np.int32).reshape(-1, 2)


def assign_labels_to_tiles(labels_px: np.ndarray, grid_xy: np.ndarray,
                           tile_size: int, boundary_threshold: float = 0.1
                           ) -> list[np.ndarray]:
    """Per-tile normalized labels (`Train_OBB.py:93-108`): a label belongs to
    the tile that holds the midpoint of its (x1, y1)-(x4, y4) edge and
    covers at least ``boundary_threshold`` of its axis-aligned box there.
    labels_px: [N, 9] (cls, x1..y4 in pixels); grid_xy: [T, 2]. Returns T
    arrays [K_t, 9] with corners clipped to the tile and normalized."""
    T = len(grid_xy)
    if labels_px.size == 0 or T == 0:
        return [np.zeros((0, 9), dtype=np.float64) for _ in range(T)]

    lab = np.asarray(labels_px, dtype=np.float64).reshape(-1, 9)
    xs, ys = lab[:, 1::2], lab[:, 2::2]
    midx = (lab[:, 1] + lab[:, 7]) / 2.0
    midy = (lab[:, 2] + lab[:, 8]) / 2.0
    x0 = grid_xy[:, 0:1].astype(np.float64)
    y0 = grid_xy[:, 1:2].astype(np.float64)
    own = ((midx[None, :] >= x0) & (midx[None, :] < x0 + tile_size)
           & (midy[None, :] >= y0) & (midy[None, :] < y0 + tile_size))
    bx1, bx2 = xs.min(1), xs.max(1)
    by1, by2 = ys.min(1), ys.max(1)
    ax = np.maximum(
        0.0, np.minimum(bx2[None], x0 + tile_size) - np.maximum(bx1[None], x0))
    ay = np.maximum(
        0.0, np.minimum(by2[None], y0 + tile_size) - np.maximum(by1[None], y0))
    area = np.maximum(1e-6, (bx2 - bx1) * (by2 - by1))
    keep = own & ((ax * ay) / area[None] >= boundary_threshold)

    out = []
    for t in range(T):
        s = lab[keep[t]].copy()
        if len(s):
            s[:, 1::2] = np.clip(s[:, 1::2] - grid_xy[t, 0], 0, tile_size)
            s[:, 2::2] = np.clip(s[:, 2::2] - grid_xy[t, 1], 0, tile_size)
            s[:, 1:] /= float(tile_size)
        out.append(s)
    return out


def extract_tiles(image: torch.Tensor, starts_xy: np.ndarray,
                  tile_size: int) -> torch.Tensor:
    """Gather [T, ts, ts, C] tiles from image [H, W, C]; area outside the
    image is PAD_VALUE. starts_xy: [T, 2] (x0, y0)."""
    ts = tile_size
    H, W, C = image.shape
    padded = torch.full((H + ts, W + ts, C), PAD_VALUE, dtype=image.dtype,
                        device=image.device)
    padded[:H, :W] = image
    return torch.stack([padded[y:y + ts, x:x + ts]
                        for x, y in np.asarray(starts_xy)[:, :2].tolist()])


def stitch_to_global(corners8_tile: torch.Tensor, starts_xy: torch.Tensor
                     ) -> torch.Tensor:
    """Shift tile-local corners [T, N, 8] by tile origins [T, 2]."""
    off = starts_xy.to(corners8_tile.dtype).repeat(1, 4)      # [T, 8]
    return corners8_tile + off[:, None, :]


def border_keep_mask(centers_global: torch.Tensor, tiles_xywh: torch.Tensor,
                     margin_px: float) -> torch.Tensor:
    """Keep iff the center is >= margin from every crop border.
    centers_global: [T, N, 2]; tiles_xywh: [T, 4] (x0, y0, cw, ch)."""
    t = tiles_xywh.to(centers_global.dtype)
    rel = centers_global - t[:, None, :2]
    cw, ch = t[:, None, 2], t[:, None, 3]
    return ((rel[..., 0] >= margin_px) & (rel[..., 0] <= cw - margin_px)
            & (rel[..., 1] >= margin_px) & (rel[..., 1] <= ch - margin_px))


def margin_for(tile_size: int, margin_128: int = 10, margin_416: int = 20
               ) -> int:
    """`Detect_OBB.py:156-157`."""
    return margin_128 if tile_size <= 128 else margin_416
