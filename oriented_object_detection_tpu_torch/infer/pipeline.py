"""Tiled single-scale OBB inference.

Per scale, on the device: gather the tile batch -> (DT-Edge if 4ch) -> /255
-> YOLO11-OBB forward -> decode -> the engine's ProbIoU NMS -> stitch to map
coordinates -> border filter -> Strike angles. On the host: the per-tile
exact-IoU merge and the global merge (``native/geom.cpp``).

Detection rows follow the reference's 11-column layout
(x1..y4 in map pixels, cls_id, conf, angle_deg).
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from ..config import CLASS_NAMES, PRESETS, DetectConfig, ScaleConfig
from ..models import decode as D
from ..models.fold import fold_bn_state
from ..models.weights import (load_checkpoint, load_state,
                              torch_state_from_jax, variables_from_checkpoint)
from ..models.yolo11_obb import YOLO11OBB
from ..ops import dtedge as DT
from ..ops import geometry as G
from ..ops import tiling as T
from ..utils import native
from ..utils.runtime import resolve_device

STRIKE_CLS = 1  # "Strike" (`Detect_OBB.py:45`, angle only for this class)
DET_WIDTH = 11  # x1..y4 (8), cls, conf, angle


class Detections:
    """ultralytics-Results-like accessor over [N, 11] detection rows."""

    def __init__(self, rows: np.ndarray):
        self.rows = np.asarray(rows, np.float64).reshape(-1, DET_WIDTH)

    def __len__(self):
        return len(self.rows)

    @property
    def xyxyxyxy(self) -> np.ndarray:
        """[N, 4, 2] corner points."""
        return self.rows[:, :8].reshape(-1, 4, 2)

    @property
    def cls(self) -> np.ndarray:
        return self.rows[:, 8].astype(np.int64)

    @property
    def conf(self) -> np.ndarray:
        return self.rows[:, 9]

    @property
    def angle(self) -> np.ndarray:
        """Strike angle in degrees (0 for non-Strike classes)."""
        return self.rows[:, 10]

    @property
    def names(self) -> dict:
        return CLASS_NAMES


def merge_detections(dets: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy class-aware exact-IoU merge (`Detect_OBB.py:176-200`); kept
    rows in conf-descending order."""
    dets = np.asarray(dets, np.float64).reshape(-1, DET_WIDTH)
    if not len(dets):
        return dets
    return dets[native.greedy_nms(dets, iou_threshold)]


class TiledDetector:
    """Single-scale tiled detector.

    params_by_scale: {tile_size: flax variables {'params', 'batch_stats'}
    as numpy trees}, the JAX package's checkpoint format
    (``models.weights.variables_from_checkpoint``). ``device=None`` runs on
    the CUDA card; pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, cfg: DetectConfig, params_by_scale: dict,
                 device=None):
        if len(cfg.scales) != 1:
            raise NotImplementedError(
                "only single-scale detection is ported; dual-scale fusion "
                "is not")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.models = {}
        for sc in cfg.scales:
            # the engine's fuse() before predict: BN folded into the
            # convs, and the fused conv + bias + SiLU graph
            state = fold_bn_state(torch_state_from_jax(
                params_by_scale[sc.tile_size]))
            model = YOLO11OBB(nc=cfg.nc, scale=sc.model_scale,
                              in_channels=cfg.channels, fused_bn=True)
            load_state(model, state)
            self.models[sc.tile_size] = model.to(self.device).eval()

    @torch.inference_mode()
    def tile_rows(self, image_bgr: np.ndarray, scale: ScaleConfig
                  ) -> np.ndarray:
        """Device part of one scale: valid detections of every tile as host
        rows [N, 13] float64 (x1..y4, cls, conf, angle, valid, tile_id) in
        (tile, conf-descending) order."""
        cfg = self.cfg
        ts = scale.tile_size
        h, w = image_bgr.shape[:2]
        grid = T.inference_tile_grid(h, w, ts, scale.overlap)
        image = torch.from_numpy(np.ascontiguousarray(image_bgr)).to(
            self.device)
        tiles = T.extract_tiles(image, grid, ts)
        x = DT.build_multich(tiles, cfg.channels, cfg.dt_edge) / 255.0
        out = self.models[ts](x)
        rbox, scores = D.decode_raw(out, ts)
        dets = D.postprocess_batch(
            rbox, scores, cfg.conf_thr_predict, cfg.engine_nms_iou,
            max_det=cfg.max_det_per_tile, pre_topk=cfg.pre_topk)
        grid_t = torch.from_numpy(grid).to(self.device)
        c8g = T.stitch_to_global(dets["corners8"], grid_t[:, :2])
        valid = dets["valid"]
        margin = float(T.margin_for(ts, cfg.margin_128, cfg.margin_416))
        if cfg.apply_border_filter and margin > 0:
            valid = valid & T.border_keep_mask(G.box_center(c8g), grid_t,
                                               margin)
        ang = torch.where(dets["cls"] == STRIKE_CLS, G.strike_angle(c8g),
                          torch.zeros_like(dets["conf"]))
        tile_id = torch.arange(len(grid), device=self.device)[:, None] \
            .expand_as(valid)
        rows = torch.cat([
            c8g, dets["cls"][..., None].float(), dets["conf"][..., None],
            ang[..., None], valid[..., None].float(),
            tile_id[..., None].float()], dim=-1)[valid]
        return rows.cpu().numpy().astype(np.float64)

    @staticmethod
    def _merge_collected(flat: np.ndarray, merge_iou: float) -> np.ndarray:
        """Host per-tile exact-IoU merge (`Detect_OBB.py:264`) over valid
        rows [N, 13]; keeps tile scan order, conf-descending in a tile."""
        if not len(flat):
            return np.zeros((0, DET_WIDTH), np.float64)
        flat = flat[np.lexsort((-flat[:, 9], flat[:, 12]))]
        keep = native.greedy_nms_grouped(
            np.ascontiguousarray(flat[:, :DET_WIDTH]),
            flat[:, 12].astype(np.int32), merge_iou)
        return np.ascontiguousarray(flat[keep][:, :DET_WIDTH])

    def detect_scale(self, image_bgr: np.ndarray, scale: ScaleConfig
                     ) -> np.ndarray:
        """All detections of one scale as [N, 11] rows, in the reference's
        order (tile scan order, conf-descending within each tile)."""
        return self._merge_collected(self.tile_rows(image_bgr, scale),
                                     self.cfg.merge_iou)

    def detect_image(self, image_bgr: np.ndarray) -> dict:
        """{'by_scale': {tile_size: [N, 11]}, 'merged_for_pr': [M, 11]}:
        the scale's rows and their global merge (`Detect_OBB.py:268-345`
        for one scale, where the consensus filter passes rows through)."""
        sc = self.cfg.scales[0]
        rows = self.detect_scale(image_bgr, sc)
        merged = merge_detections(rows, self.cfg.merge_iou)
        return {"by_scale": {sc.tile_size: rows}, "merged_for_pr": merged}

    def predict(self, image_bgr: np.ndarray) -> Detections:
        """``detect_image`` behind the ultralytics-Results accessors."""
        return Detections(self.detect_image(image_bgr)["merged_for_pr"])


# what a checkpoint must record for the port's detector to run it, and why
# anything else is refused
_SUPPORTED = {
    "channels": (4, "the 3-channel path is not ported yet"),
    "tile_size": (416, "the detector runs the detect_416_4ch preset's "
                       "416/100 scale only"),
    "model_scale": ("n", "the x-scale checkpoints need the int8 dequant, "
                         "which is not ported yet"),
}


def detector_from_checkpoint(path: str, device=None) -> TiledDetector:
    """The ``detect_416_4ch`` detector (one 416/100 scale, 4 channels) for a
    checkpoint that records ``channels=4``, ``tile_size=416`` and
    ``model_scale='n'`` in its ``extra``; any other checkpoint raises
    ``ValueError``."""
    ck = load_checkpoint(path)
    extra = ck.get("extra", {})
    for key, (want, why) in _SUPPORTED.items():
        if extra.get(key) != want:
            raise ValueError(f"checkpoint {path} records {key}="
                             f"{extra.get(key)!r}, not {want!r}: {why}")
    cfg = PRESETS["detect_416_4ch"]
    sc = dataclasses.replace(cfg.scales[0], checkpoint=path, model_scale="n")
    return TiledDetector(dataclasses.replace(cfg, scales=(sc,)),
                         {sc.tile_size: variables_from_checkpoint(ck)},
                         device=device)
