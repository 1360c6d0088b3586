"""Training batch loader for the tile dataset, the port of the JAX package's
``data/loader.py``.

Feeds the trainer from the list files the dataset build writes: YOLO-OBB
8-point normalized labels -> (cx, cy, w, h, theta) targets in pixels, uint8
tiles -> float batches, with the engine's train-time augmentation (mosaic-4,
horizontal flip, HSV jitter).

The pixel path runs on the dataset's device: every tile is uploaded once
into a [N, ts, ts, C] uint8 cache, and each batch gathers 4 tiles a sample,
composes the 2ts x 2ts mosaic canvas, warps it back to ts x ts in fixed
point (``ops/warp.py``), flips and HSV-jitters there. The label math and
every random draw stay on the host, in the JAX package's order, so one seed
gives the JAX package's batch bit for bit. ``mosaic_pixels_host`` is the
numpy mirror of the device mosaic.

Batches: images [B, C, ts, ts] float32 in 0..1, gt_labels [B, M] int64,
gt_xywhr [B, M, 5] float32 in pixels, gt_mask [B, M] bool, all on the
device.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator

import numpy as np
import torch

from ..ops import augment as AUG
from ..ops import geometry as G
from ..ops import warp as W
from ..utils.runtime import resolve_device
from . import labels as L

BORDER = 114


def load_tile(path: str) -> np.ndarray:
    """A tile in the network's channel order: [H, W, 3] uint8 RGB for
    jpg/png (cv2 reads BGR; the detector feeds RGB), or [R, G, B, DT] for a
    4-channel multipage tiff (`Train_OBB.py:271-282`)."""
    import cv2

    if path.lower().endswith((".tif", ".tiff")):
        ok, pages = cv2.imreadmulti(path, flags=cv2.IMREAD_GRAYSCALE)
        if not ok:
            raise IOError(f"cannot read tiff: {path}")
        return np.stack(pages, axis=-1)
    img = cv2.imread(path)
    if img is None:
        raise IOError(f"cannot read image: {path}")
    return img[..., ::-1]


def mosaic_p_for_epoch(epoch: int, total_epochs: int, close_mosaic: int,
                       base_p: float = 1.0) -> float:
    """The engine's close_mosaic: mosaic off from epoch ``total_epochs -
    close_mosaic`` on, and never off when the run is shorter than the
    close-out window (the engine's trigger epoch would be negative)."""
    thr = total_epochs - close_mosaic
    if close_mosaic > 0 and 0 <= thr <= epoch:
        return 0.0
    return base_p


def label_path_for_tile(image_path: str) -> str:
    """The images/ -> labels/ sibling layout of the dataset build."""
    d, fn = os.path.split(image_path)
    stem = os.path.splitext(fn)[0]
    cand = os.path.join(d.replace(
        f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"),
        stem + ".txt")
    if os.path.exists(cand):
        return cand
    return os.path.join(d, stem + ".txt")


class TileDataset:
    """List-file dataset of (tile image, normalized OBB labels).

    ``reader(path) -> [H, W, C] uint8`` in the network's channel order reads
    an image (``load_tile`` with cv2 when None). ``device=None`` keeps the
    tile cache on the CUDA card; pass ``device="cpu"`` for the CPU."""

    def __init__(self, list_file: str, tile_size: int, channels: int = 3,
                 max_labels: int = 64, device=None,
                 reader: Callable[[str], np.ndarray] | None = None):
        with open(list_file) as f:
            self.paths = [ln.strip() for ln in f if ln.strip()]
        self.tile_size = tile_size
        self.channels = channels
        self.max_labels = max_labels
        self.device = resolve_device(device)
        self.reader = reader or load_tile
        self._cache = None              # [N, ts, ts, C] uint8 on device
        self._sized: dict = {}          # idx -> (img, cls, c8), host
        self._labels: dict = {}         # idx -> (cls, c8), host

    def __len__(self):
        return len(self.paths)

    def _read_sized(self, i: int) -> np.ndarray:
        ts = self.tile_size
        img = np.asarray(self.reader(self.paths[i]))
        if img.shape[:2] != (ts, ts):
            import cv2

            img = cv2.resize(img, (ts, ts))
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] != self.channels:
            raise ValueError(f"{self.paths[i]}: {img.shape[-1]} channels, "
                             f"the dataset has {self.channels}")
        return img

    def tile_cache(self) -> torch.Tensor:
        """Every tile at (ts, ts) in one uint8 tensor on the device, built
        on first use."""
        if self._cache is None:
            ts, C = self.tile_size, self.channels
            arr = np.empty((len(self.paths), ts, ts, C), np.uint8)
            for i in range(len(self.paths)):
                arr[i] = self._read_sized(i)
            self._cache = torch.from_numpy(arr).to(self.device)
        return self._cache

    def get(self, i: int):
        """(image as read, normalized labels [N, 9]) of tile i, host."""
        p = self.paths[i]
        return (np.asarray(self.reader(p)),
                L.read_labels(label_path_for_tile(p)))

    def _get_sized(self, i: int):
        """Tile i at (ts, ts) with its labels in pixel corner coords, host;
        memoized and read-only."""
        hit = self._sized.get(i)
        if hit is None:
            cls, c8 = self._labels_sized(i)
            hit = self._sized[i] = (self._read_sized(i), cls, c8)
        return hit

    def _labels_sized(self, i: int):
        """Labels of tile i in pixel corner coords at (ts, ts); memoized and
        read-only (``mosaic_labels`` copies before it changes them)."""
        hit = self._labels.get(i)
        if hit is None:
            lab = L.read_labels(label_path_for_tile(self.paths[i]))
            ts = self.tile_size
            c8 = lab[:, 1:] * ts if len(lab) else np.zeros((0, 8))
            cls = lab[:, 0] if len(lab) else np.zeros((0,))
            hit = self._labels[i] = (cls, c8)
        return hit

    def mosaic_params(self, i: int, rng: np.random.RandomState):
        """All randomness of one mosaic sample, in the JAX package's draw
        order: (idxs[4], yc, xc, s, tx, ty); scale U(0.5, 1.5), translate
        +-0.1, engine-style."""
        ts = self.tile_size
        idxs = [i] + list(rng.randint(0, len(self.paths), 3))
        yc = int(rng.uniform(0.5 * ts, 1.5 * ts))
        xc = int(rng.uniform(0.5 * ts, 1.5 * ts))
        s = rng.uniform(0.5, 1.5)
        tx = ts * (0.5 + rng.uniform(-0.1, 0.1)) - s * ts
        ty = ts * (0.5 + rng.uniform(-0.1, 0.1)) - s * ts
        return idxs, yc, xc, s, tx, ty

    def mosaic_labels(self, params):
        """Label math of the mosaic (host): each tile's shift into canvas
        coords, the affine, the center-inside and size filter."""
        idxs, yc, xc, s, tx, ty = params
        ts = self.tile_size
        cls_all, c8_all = [], []
        for k, idx in enumerate(idxs):
            cls, c8 = self._labels_sized(idx)
            if len(c8):
                shifted = c8.copy()
                shifted[:, 0::2] += (xc - ts) if k in (0, 2) else xc
                shifted[:, 1::2] += (yc - ts) if k in (0, 1) else yc
                cls_all.append(cls)
                c8_all.append(shifted)
        cls_m = np.concatenate(cls_all) if cls_all else np.zeros((0,))
        c8_m = np.concatenate(c8_all) if c8_all else np.zeros((0, 8))
        if len(c8_m):
            pts = c8_m.reshape(-1, 4, 2) * s + np.array([tx, ty])
            c8_m = pts.reshape(-1, 8)
            cx = c8_m[:, 0::2].mean(1)
            cy = c8_m[:, 1::2].mean(1)
            wh_ok = (np.ptp(c8_m[:, 0::2], axis=1) > 2) & \
                    (np.ptp(c8_m[:, 1::2], axis=1) > 2)
            keep = (cx >= 0) & (cx < ts) & (cy >= 0) & (cy < ts) & wh_ok
            cls_m, c8_m = cls_m[keep], c8_m[keep]
        return cls_m, c8_m

    def mosaic_pixels_host(self, params) -> np.ndarray:
        """Numpy mirror of the device mosaic: paste the 4 tiles around the
        center, then the fixed-point warp back to (ts, ts)."""
        idxs, yc, xc, s, tx, ty = params
        ts = self.tile_size
        canvas = np.full((2 * ts, 2 * ts, self.channels), BORDER, np.uint8)
        for k, idx in enumerate(idxs):
            img, _, _ = self._get_sized(idx)
            if k == 0:    # top-left of the center
                x1a, y1a = max(xc - ts, 0), max(yc - ts, 0)
                x2a, y2a = xc, yc
                x1b, y1b = ts - (x2a - x1a), ts - (y2a - y1a)
            elif k == 1:  # top-right
                x1a, y1a = xc, max(yc - ts, 0)
                x2a, y2a = min(xc + ts, 2 * ts), yc
                x1b, y1b = 0, ts - (y2a - y1a)
            elif k == 2:  # bottom-left
                x1a, y1a = max(xc - ts, 0), yc
                x2a, y2a = xc, min(yc + ts, 2 * ts)
                x1b, y1b = ts - (x2a - x1a), 0
            else:         # bottom-right
                x1a, y1a = xc, yc
                x2a, y2a = min(xc + ts, 2 * ts), min(yc + ts, 2 * ts)
                x1b, y1b = 0, 0
            x2b, y2b = x1b + (x2a - x1a), y1b + (y2a - y1a)
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        M = np.array([[s, 0, tx], [0, s, ty]], np.float64)
        return W.warp_affine_u8_np(canvas, W.invert_affine(M), ts, ts,
                                   (BORDER,) * self.channels)

    def _mosaic_device(self, tiles, yc, xc, wtab) -> torch.Tensor:
        """The device mosaic of a batch: tiles [B, 4, ts, ts, C], centers
        [B], warp tables [B, 4, ts] -> uint8 [B, ts, ts, C]. The canvas is
        the 2x2 grid of the tiles shifted so that its center lands on
        (yc, xc), with the area no tile covers set to the border."""
        ts, dev = self.tile_size, self.device
        grid = torch.cat([torch.cat([tiles[:, 0], tiles[:, 1]], dim=2),
                          torch.cat([tiles[:, 2], tiles[:, 3]], dim=2)],
                         dim=1)                      # [B, 2ts, 2ts, C]
        r = torch.arange(2 * ts, device=dev)
        ry = r[None] - (yc[:, None] - ts)            # canvas row -> grid row
        rx = r[None] - (xc[:, None] - ts)
        oky = (ry >= 0) & (ry < 2 * ts)
        okx = (rx >= 0) & (rx < 2 * ts)
        b = torch.arange(len(yc), device=dev)[:, None, None]
        canvas = grid[b, ry.clamp(0, 2 * ts - 1)[:, :, None],
                      rx.clamp(0, 2 * ts - 1)[:, None, :]]
        ok = oky[:, :, None] & okx[:, None, :]
        canvas = torch.where(ok[..., None], canvas,
                             torch.full_like(canvas, BORDER))
        return W.warp_axis_aligned_u8(canvas, wtab[:, 0], wtab[:, 2],
                                      wtab[:, 3], (BORDER,) * self.channels)

    def batches(self, batch_size: int, rng: np.random.RandomState,
                shuffle: bool = True, augment: bool = True,
                mosaic_p: float = 1.0, fliplr_p: float = 0.5,
                hsv_s: float = 0.7, hsv_v: float = 0.4,
                drop_last: bool = True, rows: tuple | None = None
                ) -> Iterator[dict]:
        """Yield padded batch dicts ready for the train step, drawing from
        ``rng`` in the JAX package's order: the shuffle, then per sample the
        mosaic coin (and the mosaic's draws), then per batch the flips and
        the S and V gains. ``rows=(start, stop)`` yields only those rows of
        each batch (one process's share of a global batch): every draw is
        still made for the whole batch, so the processes' streams are one
        stream, and only the rows' tiles are gathered, mosaicked and
        warped."""
        cache = self.tile_cache()
        dev = self.device
        order = np.arange(len(self.paths))
        if shuffle:
            rng.shuffle(order)
        ts, M = self.tile_size, self.max_labels
        n = len(order)
        end = n - (n % batch_size) if drop_last else n
        for s in range(0, max(end, 0), batch_size):
            idx = order[s:s + batch_size]
            lo, hi = rows if rows is not None else (0, len(idx))
            B = hi - lo
            gl = np.zeros((B, M), np.int64)
            gb = np.zeros((B, M, 5), np.float32)
            gm = np.zeros((B, M), bool)
            tidx = np.zeros((B, 4), np.int64)
            yc = np.zeros((B,), np.int64)
            xc = np.zeros((B,), np.int64)
            wtab = np.zeros((B, 4, ts), np.int32)  # adelta/bdelta/X0/Y0
            is_mos = np.zeros((B,), bool)
            for j, i in enumerate(idx):
                bi = j - lo
                if augment and rng.rand() < mosaic_p:
                    params = self.mosaic_params(i, rng)
                    if not 0 <= bi < B:
                        continue
                    cls, c8 = self.mosaic_labels(params)
                    idxs, yc[bi], xc[bi], sc, tx, ty = params
                    tidx[bi] = idxs
                    wtab[bi] = W.affine_deltas(W.invert_affine(
                        np.array([[sc, 0, tx], [0, sc, ty]])), ts, ts)
                    is_mos[bi] = True
                elif not 0 <= bi < B:
                    continue
                else:
                    tidx[bi] = i
                    cls, c8 = self._labels_sized(i)
                if len(cls):
                    cls, c8 = cls[:M], c8[:M]
                    k = len(cls)
                    gl[bi, :k] = cls.astype(np.int64)
                    gb[bi, :k] = G.corners8_to_xywhr_np(c8)
                    gm[bi, :k] = True

            tiles = cache[torch.from_numpy(tidx).to(dev)]  # [B,4,ts,ts,C]
            imgs = tiles[:, 0]
            if is_mos.any():
                mos = self._mosaic_device(
                    tiles, torch.from_numpy(yc).to(dev),
                    torch.from_numpy(xc).to(dev),
                    torch.from_numpy(wtab).to(dev))
                imgs = torch.where(
                    torch.from_numpy(is_mos).to(dev)[:, None, None, None],
                    mos, imgs)
            x = imgs.to(torch.float32)
            gbt = torch.from_numpy(gb).to(dev)
            if augment:
                n_all = len(idx)
                flips = (rng.rand(n_all) < fliplr_p)[lo:hi]
                sg = np.maximum(1.0 + rng.uniform(-1, 1, n_all) * hsv_s,
                                0.0)[lo:hi]
                vg = np.maximum(1.0 + rng.uniform(-1, 1, n_all) * hsv_v,
                                0.0)[lo:hi]
                fl = torch.from_numpy(flips).to(dev)
                x = torch.where(fl[:, None, None, None], AUG.fliplr_image(x),
                                x)
                if self.channels == 3:
                    # per-sample gains (the engine draws HSV per image)
                    x = AUG.hsv_jitter(
                        x, torch.from_numpy(sg.astype(np.float32)).to(dev)[
                            :, None, None],
                        torch.from_numpy(vg.astype(np.float32)).to(dev)[
                            :, None, None])
                flipped = gbt.clone()
                flipped[..., 0] = float(ts) - gbt[..., 0]
                flipped[..., 4] = gbt[..., 4] * -1.0
                gbt = torch.where(fl[:, None, None], flipped, gbt)
                # the JAX package scales inside a compiled program here,
                # where XLA multiplies by the float32 reciprocal
                x = x * AUG.INV_255
            else:
                x = x / 255.0
            yield {
                "images": x.permute(0, 3, 1, 2).contiguous(),
                "gt_labels": torch.from_numpy(gl).to(dev),
                "gt_xywhr": gbt,
                "gt_mask": torch.from_numpy(gm).to(dev),
            }
