"""Seeded synthetic map sheets and the training tiles cut from them.

A map is ``chip_smoke.synthetic_map``'s kind, at its density scaled by
area: a noisy light background, thin dark lines and filled rotated
rectangles in the six palette colours the committed checkpoints were fit
on (40 rectangles and 12 lines a 1024 x 1024 map). The background and the
lines are drawn on the device from a ``torch.Generator``; the shapes'
parameters come from numpy's ``SeedSequence`` of the run's seed and a
purpose, so any whole number is a seed and the same seed gives the same
maps; the rectangles are painted on the host in a window around each.
"""

from __future__ import annotations

import numpy as np
import torch

PALETTE = [(200, 40, 40), (40, 200, 40), (40, 40, 200), (200, 200, 40),
           (200, 40, 200), (40, 200, 200)]
OBJ_PER_MPIX = 40 / 2 ** 20
LINES_PER_MPIX = 12 / 2 ** 20


def rng_for(seed: int, *purpose: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        [int(seed) % 2 ** 64, *purpose])))


def synthetic_map(seed: int, index: int, H: int, W: int, device) -> tuple:
    """(BGR uint8 [H, W, 3] numpy map, ground truth [n, 9]: palette class,
    then the rectangle's corners in pixels) of map ``index`` of ``seed``."""
    rng = rng_for(seed, 1, index)
    n_obj = max(1, round(OBJ_PER_MPIX * H * W))
    n_lines = max(1, round(LINES_PER_MPIX * H * W))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2 ** 62)))
    img = (230 - torch.randint(0, 40, (H, W, 3), generator=gen,
                               device=device)).to(torch.int16)
    yy = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    for x0, x1, y0, y1 in rng.uniform(0, 1, (n_lines, 4)) * [W, W, H, H]:
        dx, dy = x1 - x0, y1 - y0
        t = torch.clamp(((xx - x0) * dx + (yy - y0) * dy)
                        / max(dx * dx + dy * dy, 1e-9), 0.0, 1.0)
        d2 = (xx - x0 - t * dx) ** 2 + (yy - y0 - t * dy) ** 2
        img[d2 <= 1.0] = 60
    img = img.to(torch.uint8).cpu().numpy()
    boxes = []
    cls_all = rng.integers(0, len(PALETTE), n_obj)
    geo = rng.uniform(0, 1, (n_obj, 5))
    for cls, (u0, v0, a, b, c) in zip(cls_all, geo):
        cx, cy = 30 + u0 * (W - 60), 30 + v0 * (H - 60)
        w, h, th = 18 + a * 22, 10 + b * 12, (2 * c - 1) * np.pi
        co, si = np.cos(th), np.sin(th)
        r = int(np.ceil(np.hypot(w, h) / 2)) + 1
        ya, yb = max(0, int(cy) - r), min(H, int(cy) + r + 1)
        xa, xb = max(0, int(cx) - r), min(W, int(cx) + r + 1)
        gy, gx = np.mgrid[ya:yb, xa:xb].astype(np.float32)
        u = (gx - cx) * co + (gy - cy) * si
        v = -(gx - cx) * si + (gy - cy) * co
        img[ya:yb, xa:xb][(np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)] = \
            PALETTE[cls]
        boxes.append([cls] + [z for su, sv in ((1, 1), (1, -1), (-1, -1),
                                               (-1, 1))
                              for z in (cx + su * w / 2 * co - sv * h / 2 * si,
                                        cy + su * w / 2 * si + sv * h / 2 * co)])
    return img, np.asarray(boxes, np.float64).reshape(-1, 9)


def tile_grid(h: int, w: int, ts: int, ov: int) -> np.ndarray:
    """[T, 4] (x0, y0, crop_w, crop_h): the detector's grid."""
    step = max(1, ts - ov)
    return np.asarray([(x, y, min(x + ts, w) - x, min(y + ts, h) - y)
                       for y in range(0, h, step) for x in range(0, w, step)],
                      np.int64).reshape(-1, 4)


def tile_labels(gt: np.ndarray, grid_xy: np.ndarray, ts: int,
                boundary: float = 0.1) -> list:
    """Per tile, the normalized labels [K, 9] (`Train_OBB.py:93-108`): a
    rectangle belongs to the tile holding the midpoint of its first and
    last corners and covering at least ``boundary`` of its box there."""
    out = []
    for x0, y0 in np.asarray(grid_xy)[:, :2].astype(np.float64):
        keep = []
        for row in gt:
            xs, ys = row[1::2], row[2::2]
            mx, my = (row[1] + row[7]) / 2, (row[2] + row[8]) / 2
            if not (x0 <= mx < x0 + ts and y0 <= my < y0 + ts):
                continue
            ax = max(0.0, min(xs.max(), x0 + ts) - max(xs.min(), x0))
            ay = max(0.0, min(ys.max(), y0 + ts) - max(ys.min(), y0))
            area = max(1e-6, (xs.max() - xs.min()) * (ys.max() - ys.min()))
            if ax * ay / area >= boundary:
                s = row.copy()
                s[1::2] = np.clip(s[1::2] - x0, 0, ts) / ts
                s[2::2] = np.clip(s[2::2] - y0, 0, ts) / ts
                keep.append(s)
        out.append(np.asarray(keep, np.float64).reshape(-1, 9))
    return out


def training_tiles(seed: int, n_maps: int, size: int, ts: int, ov: int,
                   device) -> tuple:
    """(RGB tiles [N, ts, ts, 3] uint8, per-tile normalized labels) cut on
    the detector's grid from ``n_maps`` maps of ``size`` pixels a side,
    edge tiles padded with 114."""
    tiles, labels = [], []
    for k in range(n_maps):
        img, gt = synthetic_map(seed, 1000 + k, size, size, device)
        grid = tile_grid(size, size, ts, ov)
        pad = np.full((size + ts, size + ts, 3), 114, np.uint8)
        pad[:size, :size] = img
        tiles += [pad[y:y + ts, x:x + ts, ::-1] for x, y, _, _ in grid]
        labels += tile_labels(gt, grid, ts)
    return np.ascontiguousarray(np.stack(tiles)), labels
