"""Plain reference of tiled dual-scale detection (`Detect_OBB.py`): the tile
grid with partial edge tiles padded with 114, the forward, decode and the
engine's NMS per tile, the shift to map pixels, the border filter, the
Strike angle, the per-tile exact-IoU merge and the cross-scale consensus
with its global merge. Float32 on the device for the tiles, float64 on
the host for the merges (``merge.py``), rows of confidence >= ``floor``
(the merges are exact on them).

An architecture brings its network: the tile's input (``reference_input``)
and the decode of its raw outputs (``reference_decode``), YOLO's by
default. Everything after the decode is the system's and the same for
every architecture: ``model.postprocess`` (top-k, the one-shot ProbIoU
NMS, ``max_det_per_tile``), the shift, the border filter, the Strike
angle and the merges."""

from __future__ import annotations

import numpy as np
import torch

from . import ckpt, merge
from . import model as M

PAD = 114
STRIKE = 1
# what an architecture module may give the reference (archs/<model>.py)
ARCH_HOOKS = ("reference_input", "reference_decode")


def yolo_input(tiles: torch.Tensor) -> torch.Tensor:
    """uint8 BGR tiles [n, ts, ts, 3] -> the float32 RGB NCHW input in
    [0, 1] of a YOLO model. (Here and not in ``model.py``: the seeded
    YOLO12 checkpoint's cache name holds a digest of that file.)"""
    return tiles.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0


def tile_grid(h: int, w: int, ts: int, ov: int) -> np.ndarray:
    """[T, 4] (x0, y0, crop_w, crop_h), steps of ts - ov, edge tiles kept."""
    step = max(1, ts - ov)
    return np.asarray([(x, y, min(x + ts, w) - x, min(y + ts, h) - y)
                       for y in range(0, h, step) for x in range(0, w, step)],
                      np.int64).reshape(-1, 4)


def load_models(cfg: dict, root: str, device, precision: str = "float32"
                ) -> dict:
    """{tile_size: reference model in eval mode} of a configuration's
    scales, each from its checkpoint file."""
    out = {}
    for sc in cfg["scales"]:
        ck = ckpt.load(f"{root}/{sc['checkpoint']}")
        out[sc["tile_size"]] = M.build(
            ckpt.state_dict(ck), cfg["model_scale"], cfg["nc"],
            cfg["channels"], device).eval().set_precision(precision)
    return out


@torch.no_grad()
def scale_rows(model, image: np.ndarray, sc: dict, cfg: dict, device,
               floor: float, tiles_per_forward: int = 256, *,
               reference_input=yolo_input, reference_decode=M.decode
               ) -> np.ndarray:
    """Valid rows [N, 12] (11 columns and the tile index) of one map at one
    scale, confidence >= ``floor``. ``reference_input(tiles)`` takes uint8
    BGR tiles [n, ts, ts, 3] on the device to the model's float32 NCHW
    input; ``reference_decode(out, ts)`` takes the model's raw outputs to
    (xywhr [n, A, 5] in tile pixels, radians; scores [n, A, nc] in
    [0, 1]). The NMS and all after it are shared."""
    ts, ov = sc["tile_size"], sc["overlap"]
    H, W = image.shape[:2]
    grid = tile_grid(H, W, ts, ov)
    padded = torch.full((H + ts, W + ts, 3), PAD, dtype=torch.uint8,
                        device=device)
    padded[:H, :W] = torch.from_numpy(image).to(device)
    margin = float(cfg["margin_128"] if ts <= 128 else cfg["margin_416"])
    out = []
    for a in range(0, len(grid), tiles_per_forward):
        g = grid[a:a + tiles_per_forward]
        tiles = torch.stack([padded[y:y + ts, x:x + ts] for x, y, _, _ in g])
        x = reference_input(tiles)
        rb, scores = reference_decode(model(x), ts)
        d = M.postprocess(rb, scores, cfg["conf_thr"], cfg["engine_nms_iou"],
                          cfg["max_det_per_tile"], cfg["pre_topk"])
        gt = torch.from_numpy(g).to(device).to(torch.float32)
        c8 = d["corners8"] + gt[:, None, :2].repeat(1, 1, 4)
        valid = d["valid"]
        if cfg["apply_border_filter"] and margin > 0:
            cen = c8.reshape(*c8.shape[:-1], 4, 2).mean(-2) - gt[:, None, :2]
            cw, ch = gt[:, None, 2], gt[:, None, 3]
            valid = valid & ((cen[..., 0] >= margin)
                             & (cen[..., 0] <= cw - margin)
                             & (cen[..., 1] >= margin)
                             & (cen[..., 1] <= ch - margin))
        ang = torch.where(d["cls"] == STRIKE, M.strike_angle(c8),
                          torch.zeros_like(d["conf"]))
        tid = torch.arange(a, a + len(g), device=device)[:, None].expand_as(
            valid).to(torch.float32)
        rows = torch.cat([c8, d["cls"][..., None].float(),
                          d["conf"][..., None], ang[..., None],
                          tid[..., None]], -1)
        keep = valid & (d["conf"] >= floor)
        out.append(rows[keep].double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, 12))


def detect_map(models: dict, image: np.ndarray, cfg: dict, device,
               floor: float, *, reference_input=yolo_input,
               reference_decode=M.decode) -> dict:
    """{'by_scale': {tile_size: rows}, 'merged_for_pr': rows} of one map,
    every row of confidence >= ``floor``; the architecture's input and
    decode as ``scale_rows`` takes them."""
    by_scale = {}
    for sc in cfg["scales"]:
        rows = scale_rows(models[sc["tile_size"]], image, sc, cfg, device,
                          floor, reference_input=reference_input,
                          reference_decode=reference_decode)
        per_tile = [merge.greedy_merge(rows[rows[:, 11] == t][:, :11],
                                       cfg["merge_iou"])
                    for t in np.unique(rows[:, 11])]
        by_scale[sc["tile_size"]] = (np.concatenate(per_tile) if per_tile
                                     else np.zeros((0, 11)))
    return {"by_scale": by_scale,
            "merged_for_pr": merge.greedy_merge(merge.consensus(by_scale),
                                                cfg["merge_iou"])}
