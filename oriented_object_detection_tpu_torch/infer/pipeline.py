"""Tiled multi-scale OBB inference.

Per scale, on the device: gather the tile batch -> (DT-Edge if 4ch) -> /255
-> YOLO11-OBB forward -> decode -> the engine's ProbIoU NMS -> stitch to map
coordinates -> border filter -> Strike angles. On the host: the per-tile
exact-IoU merge, the cross-scale consensus fusion and the global merges
(``infer/fusion.py``, ``native/geom.cpp``), then the ``{stem}_detected.jpg``
and ``{stem}.xlsx`` outputs.

Detection rows follow the reference's 11-column layout
(x1..y4 in map pixels, cls_id, conf, angle_deg).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import CLASS_COLORS, CLASS_NAMES, DetectConfig, ScaleConfig
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
from ..utils.xlsx import export_xlsx
from . import fusion as F

STRIKE_CLS = 1  # "Strike" (`Detect_OBB.py:45`, angle only for this class)
DET_WIDTH = F.DET_WIDTH


class Detections:
    """ultralytics-Results-like accessor over [N, 11] detection rows."""

    def __init__(self, rows: np.ndarray):
        self.rows = np.asarray(rows, np.float64).reshape(-1, DET_WIDTH)

    def __len__(self):
        return len(self.rows)

    def __iter__(self):
        for r in self.rows:
            yield Detections(r[None])

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


class TiledDetector:
    """Tiled multi-scale detector.

    params_by_scale: {tile_size: flax variables {'params', 'batch_stats'}
    as numpy trees}, the JAX package's checkpoint format
    (``models.weights.variables_from_checkpoint``); each scale's model is
    built at its ``ScaleConfig.model_scale``. ``device=None`` runs on the
    CUDA card; pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, cfg: DetectConfig, params_by_scale: dict,
                 device=None):
        sizes = [sc.tile_size for sc in cfg.scales]
        if len(set(sizes)) != len(sizes):
            # models and results are keyed by tile size
            raise ValueError(f"duplicate tile sizes in the scales: {sizes}")
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

    def _conf_thr(self) -> float:
        return (self.cfg.conf_thr_metrics if self.cfg.calculate_metrics
                else self.cfg.conf_thr_predict)

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
            rbox, scores, self._conf_thr(), cfg.engine_nms_iou,
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
        """Every scale, then the fusion (`Detect_OBB.py:268-345`):
        {'by_scale': {tile_size: [N, 11]}, 'merged_for_pr': the global merge
        of the cross-scale consensus} and, under ``calculate_metrics``,
        'merged_for_map': the global merge of the union of the scales."""
        by_scale = {sc.tile_size: self.detect_scale(image_bgr, sc)
                    for sc in self.cfg.scales}
        result = {"by_scale": by_scale}
        if self.cfg.calculate_metrics:
            result["merged_for_map"] = F.merge_detections(
                np.concatenate(list(by_scale.values())), self.cfg.merge_iou)
        result["merged_for_pr"] = F.merge_detections(
            F.cross_scale_consensus_filter(by_scale), self.cfg.merge_iou)
        return result

    def predict(self, image_bgr: np.ndarray) -> Detections:
        """``detect_image`` behind the ultralytics-Results accessors."""
        return Detections(self.detect_image(image_bgr)["merged_for_pr"])


def read_scales(triples, channels: int = 3, model_scale: str = "x"
                ) -> tuple:
    """(scales, params_by_scale) for ``(tile_size, overlap, checkpoint)``
    triples, with each checkpoint's ``extra`` read as the JAX package's
    ``cli.py detect`` reads it: a recorded ``channels`` other than
    ``channels`` raises, a recorded ``model_scale`` wins over
    ``model_scale``, a recorded ``tile_size`` other than the scale's warns.
    Duplicate tile sizes and missing checkpoints raise ``ValueError``."""
    scales, params = [], {}
    for ts, ov, ck in triples:
        if ts in params:
            raise ValueError(f"duplicate tile size {ts} in the scales")
        if ck is None or not os.path.exists(ck):
            raise ValueError(f"checkpoint {ck} for scale {ts} does not "
                             f"exist")
        ckd = load_checkpoint(ck)
        extra = ckd.get("extra", {})
        ck_ch = extra.get("channels")
        if ck_ch is not None and int(ck_ch) != channels:
            raise ValueError(f"checkpoint {ck} was trained with channels="
                             f"{ck_ch} but --channels {channels} was "
                             f"requested")
        msc = model_scale
        ck_sc = extra.get("model_scale")
        if ck_sc and ck_sc != msc:
            print(f"[detect] scale {ts}: using the checkpoint's recorded "
                  f"model_scale={ck_sc} (over --scale {msc})")
            msc = ck_sc
        ck_ts = extra.get("tile_size")
        if ck_ts and int(ck_ts) != ts:
            print(f"[WARN] checkpoint {ck} was trained at tile_size="
                  f"{ck_ts}; running it at {ts} (fully convolutional, but "
                  f"detection quality follows the training scale)")
        params[ts] = variables_from_checkpoint(ckd)
        scales.append(ScaleConfig(ts, ov, checkpoint=ck, model_scale=msc))
    if not scales:
        raise ValueError("no scale given")
    return tuple(scales), params


def build_detector(triples, channels: int = 3, model_scale: str = "x",
                   device=None, **cfg_fields) -> TiledDetector:
    """A detector over ``(tile_size, overlap, checkpoint)`` triples (see
    ``read_scales``); ``cfg_fields`` set other ``DetectConfig`` fields."""
    scales, params = read_scales(triples, channels, model_scale)
    cfg = DetectConfig(scales=scales, channels=channels, **cfg_fields)
    return TiledDetector(cfg, params, device=device)


def draw_detections(image_bgr: np.ndarray, dets: np.ndarray) -> np.ndarray:
    """Annotated copy: polylines and 'label conf' text
    (`Detect_OBB.py:304-316`)."""
    import cv2

    out = image_bgr.copy()
    H, W = out.shape[:2]
    for row in dets:
        x1, y1, x2, y2, x3, y3, x4, y4, cls_id, conf = row[:10]
        cls_id = int(cls_id)
        color = tuple(int(c) for c in CLASS_COLORS.get(cls_id, (0, 255, 255)))
        label = CLASS_NAMES.get(cls_id, f"Class{cls_id}")
        pts = np.array([[x1, y1], [x2, y2], [x3, y3], [x4, y4]], np.int32)
        cv2.polylines(out, [pts], isClosed=True, color=color, thickness=2)
        tx = int(max(0, min(W - 1, round(min(x1, x2, x3, x4)))))
        ty = int(max(0, min(H - 1, round(min(y1, y2, y3, y4) - 10))))
        cv2.putText(out, f"{label} {conf:.2f}", (tx, ty),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 2,
                    lineType=cv2.LINE_AA)
    return out


def process_image(detector: TiledDetector, image_path: str, output_dir: str,
                  store: dict | None = None) -> dict:
    """Detect, draw and export one image (`Detect_OBB.py:268-345`):
    ``{stem}_detected.jpg`` and ``{stem}.xlsx`` in ``output_dir``, and the
    rows the metrics need in ``store`` ('pr', and 'map' under
    ``calculate_metrics``)."""
    import cv2

    t0 = time.time()
    image = cv2.imread(image_path)
    if image is None:
        print(f"[Warn] Could not read image: {image_path}")
        return {}

    result = detector.detect_image(image)
    merged = result["merged_for_pr"]
    elapsed = time.time() - t0
    print(f"--- {elapsed:.3f} seconds ---")

    stem = os.path.splitext(os.path.basename(image_path))[0]
    os.makedirs(output_dir, exist_ok=True)
    cv2.imwrite(os.path.join(output_dir, f"{stem}_detected.jpg"),
                draw_detections(image, merged))
    export_xlsx(os.path.join(output_dir, f"{stem}.xlsx"), merged)

    if store is not None:
        store.setdefault("pr", {})[image_path] = merged
        if "merged_for_map" in result:
            store.setdefault("map", {})[image_path] = result[
                "merged_for_map"]
    result["seconds"] = elapsed
    return result
