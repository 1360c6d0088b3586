"""Validation during training, the port of the JAX package's
``eval/val.py``: the val tiles in batches through the model, decode and the
engine's NMS, then the exact-IoU mAP evaluator. The fitness is the engine's
blend 0.1 * mAP@0.5 + 0.9 * mAP@[0.5:0.95], which picks best.ckpt and
drives the early-stop patience.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TrainConfig
from ..models import decode as D
from ..parallel import distributed as PD
from . import metrics as M


def _letterbox_np(img: np.ndarray, new_size: int, pad_value: int = 114):
    """Aspect-preserving resize and center pad with 114, the engine's val
    preprocessing (cv2). Returns (out, r, (dw, dh)): a source point (x, y)
    lands at (x * r + dw, y * r + dh)."""
    import cv2

    h, w = img.shape[:2]
    r = min(new_size / h, new_size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    if resized.ndim == 2:
        resized = resized[:, :, None]
    dh, dw = (new_size - nh) / 2, (new_size - nw) / 2
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    out = np.full((new_size, new_size, img.shape[2]), pad_value, img.dtype)
    out[top:top + nh, left:left + nw] = resized
    return out, r, (left, top)


def _gather_by_tile(rows_by_tile: dict, order, width: int) -> dict:
    """Every process's {tile index: rows [k, width]} gathered to every
    process, keyed in the global tile ``order``: one row gather of the
    rows with their tile index in front."""
    flat = [np.concatenate([np.full((len(r), 1), i, np.float64), r], axis=1)
            for i, r in rows_by_tile.items()]
    flat = np.concatenate(flat) if flat else np.zeros((0, width + 1))
    every = PD.all_gather_rows(torch.from_numpy(flat)).numpy()
    tile = every[:, 0].astype(np.int64)
    return {int(i): every[tile == i, 1:] for i in order}


@torch.inference_mode()
def validate_tiles(model: torch.nn.Module, val_ds, cfg: TrainConfig,
                   max_tiles: int | None = None, batch_size: int = 16,
                   conf_thr: float = 0.001, return_components: bool = False,
                   shard_across_processes: bool = False):
    """Fitness of ``model`` (in eval mode, on the device it is on) over the
    val tile dataset; with ``return_components`` also the mAP breakdown
    (``val``, the engine's ``model.val()``). ``max_tiles`` evaluates a
    seeded random subset.

    ``shard_across_processes`` in a data-parallel group: each process runs
    the stride slice ``order[rank::world]`` of the tile order, then the
    detection and ground-truth rows are gathered to every process, which
    evaluates the same global metric in the global tile order."""
    dev = next(model.parameters()).device
    ts = cfg.tile_size
    n = len(val_ds) if max_tiles is None else min(len(val_ds), max_tiles)
    order = np.arange(len(val_ds))
    if max_tiles is not None and len(val_ds) > max_tiles:
        np.random.RandomState(0).shuffle(order)
    order = order[:n]
    shard = shard_across_processes and PD.world() > 1
    local = order[PD.rank()::PD.world()] if shard else order

    dets_per_image: dict = {}
    gt_map: dict = {}
    for s in range(0, len(local), batch_size):
        idx = local[s:s + batch_size]
        imgs = np.zeros((len(idx), ts, ts, cfg.channels), np.float32)
        keys = []
        for bi, i in enumerate(idx):
            img, lab = val_ds.get(i)
            if img.shape[:2] != (ts, ts):
                # engine letterbox: detections come out in the letterboxed
                # frame, so the GT (normalized to the source tile) follows
                h0, w0 = img.shape[:2]
                img, r, (dw, dh) = _letterbox_np(img, ts)
                gt = lab.copy() if len(lab) else np.zeros((0, 9))
                gt[:, 1:9:2] = gt[:, 1:9:2] * w0 * r + dw
                gt[:, 2:9:2] = gt[:, 2:9:2] * h0 * r + dh
            else:
                gt = np.concatenate([lab[:, :1], lab[:, 1:] * ts], axis=1) \
                    if len(lab) else np.zeros((0, 9))
            imgs[bi] = img
            key = val_ds.paths[i]
            gt_map[key] = gt
            keys.append(key)
        x = torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2) / 255.0
        rbox, scores = D.decode_raw(model(x), ts)
        dets = D.postprocess_batch(rbox, scores, conf_thr, 0.7, max_det=64,
                                   pre_topk=256)
        c8 = dets["corners8"].double().cpu().numpy()
        cls = dets["cls"].double().cpu().numpy()
        conf = dets["conf"].double().cpu().numpy()
        valid = dets["valid"].cpu().numpy()
        for bi, key in enumerate(keys):
            sel = valid[bi]
            dets_per_image[key] = np.concatenate(
                [c8[bi][sel], cls[bi][sel][:, None], conf[bi][sel][:, None],
                 np.zeros((sel.sum(), 1))], axis=1)

    if shard:
        index = {val_ds.paths[i]: int(i) for i in local}
        dets = _gather_by_tile({index[k]: v for k, v in
                                dets_per_image.items()}, order, 11)
        gts = _gather_by_tile({index[k]: v for k, v in gt_map.items()},
                              order, 9)
        dets_per_image = {val_ds.paths[i]: dets[i] for i in dets}
        gt_map = {val_ds.paths[i]: gts[i] for i in gts}

    cache = M.GTCache(loader=lambda p: gt_map.get(p, np.zeros((0, 9))))
    out = M.evaluate_map(dets_per_image, list(dets_per_image),
                         [0.5 + 0.05 * i for i in range(10)], cache)
    map50 = float(out["mAP@0.5"])
    map5095 = float(out["mAP@mean"])
    fitness = 0.1 * map50 + 0.9 * map5095
    if return_components:
        return fitness, {"mAP@0.5": map50, "mAP@[0.5:0.95]": map5095,
                         "n_tiles": n}
    return fitness
