"""Inference tiling: the sliding-window grid with partial edge tiles, the
batched tile gather, tile->global stitching and the border filter
(`Detect_OBB.py:156-174,216-240`)."""

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
