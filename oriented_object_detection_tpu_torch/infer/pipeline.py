"""Tiled multi-scale OBB inference.

Per scale, on the device: gather the tile batch -> (DT-Edge if 4ch) -> /255
-> YOLO11-OBB forward -> decode -> the engine's ProbIoU NMS -> stitch to map
coordinates -> border filter -> Strike angles. On the host: the per-tile
exact-IoU merge, the cross-scale consensus fusion and the global merges
(``infer/fusion.py``, ``native/geom.cpp``), then the ``{stem}_detected.jpg``
and ``{stem}.xlsx`` outputs.

``detect_images`` runs one device batch per scale over the tiles of several
maps; ``detect_stream`` pipelines groups of maps, uploading the next group
and running its device work while the host merges the last. The device part
queues without a host synchronization: each scale's fixed-shape rows come
back into pinned memory behind a CUDA event that the host waits on before
its merges, and the stream uploads each later group from pinned memory on a
side stream. The tiles go through the network in chunks of a fixed number
of pixels, so memory stays bounded however many maps come.
``predict_crop`` is the reference's single-crop predictor (letterbox, one
forward, no tiling).

Detection rows follow the reference's 11-column layout
(x1..y4 in map pixels, cls_id, conf, angle_deg).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import (CLASS_COLORS, CLASS_NAMES, DetectConfig, ScaleConfig,
                      torch_dtype)
from ..models import decode as D
from ..models.fold import fold_bn_state
from ..models.weights import (jax_trees_from_torch_state, load_checkpoint,
                              load_state, torch_state_from_jax,
                              variables_from_checkpoint)
from ..models.yolo11_obb import YOLO11OBB
from ..ops import dtedge as DT
from ..ops import geometry as G
from ..ops import image as IM
from ..ops import tiling as T
from ..parallel import distributed as PD
from ..parallel import mesh as PM
from ..utils import native
from ..utils import profiling as prof
from ..utils.runtime import resolve_device
from ..utils.xlsx import export_xlsx
from . import fusion as F

STRIKE_CLS = 1  # "Strike" (`Detect_OBB.py:45`, angle only for this class)
DET_WIDTH = F.DET_WIDTH
# tile pixels through one forward, so one forward and its NMS hold a bounded
# amount of memory: 192 tiles of 416 or 2048 of 128 (the peaks it gives are
# in PERF.md section 5)
TILE_PIXELS_PER_FORWARD = 1 << 25


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
    CUDA card; pass ``device="cpu"`` for the CPU. The network computes in
    ``cfg.compute_dtype``: the tiles are cast after ``/255`` (DT-Edge is
    built in float32 before), decode and NMS upcast to float32.
    """

    def __init__(self, cfg: DetectConfig, params_by_scale: dict,
                 device=None):
        sizes = [sc.tile_size for sc in cfg.scales]
        if len(set(sizes)) != len(sizes):
            # models and results are keyed by tile size
            raise ValueError(f"duplicate tile sizes in the scales: {sizes}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = torch_dtype(cfg.compute_dtype)
        self.models = {}
        for sc in cfg.scales:
            # the engine's fuse() before predict: BN folded into the
            # convs, and the fused conv + bias + SiLU graph
            state = fold_bn_state(torch_state_from_jax(
                params_by_scale[sc.tile_size]))
            model = YOLO11OBB(nc=cfg.nc, scale=sc.model_scale,
                              in_channels=cfg.channels, fused_bn=True)
            load_state(model, state)
            # the folded weights in the compute dtype, once: the values of
            # flax's cast of the float32 weights at every apply
            self.models[sc.tile_size] = model.to(self.device,
                                                 self.dtype).eval()
        self._side_stream = None   # the card's upload stream, made on use

    def _conf_thr(self) -> float:
        return (self.cfg.conf_thr_metrics if self.cfg.calculate_metrics
                else self.cfg.conf_thr_predict)

    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    def _upload(self, images_bgr: list, side: bool = False) -> tuple:
        """(device maps, {tile_size: (host tile grids, one per map, and
        their concatenation on the device)}, upload event or None). With
        ``side`` on the card, the maps and grids go up from pinned memory
        on a side stream, so the upload overlaps the work already queued
        on the compute stream, and ``_dispatch`` makes the compute stream
        wait for the event; otherwise they go up directly."""
        grids = {sc.tile_size: [T.inference_tile_grid(
            im.shape[0], im.shape[1], sc.tile_size, sc.overlap)
            for im in images_bgr] for sc in self.cfg.scales}
        host = [np.ascontiguousarray(im) for im in images_bgr] + [
            np.concatenate(g) for g in grids.values()]
        with prof.timed("detect/h2d"):
            if not (side and self._on_card()):
                dev, done = [torch.from_numpy(a).to(self.device)
                             for a in host], None
            else:
                if self._side_stream is None:
                    self._side_stream = torch.cuda.Stream(self.device)
                with torch.cuda.stream(self._side_stream):
                    dev = [torch.from_numpy(a).pin_memory().to(
                        self.device, non_blocking=True) for a in host]
                    done = torch.cuda.Event()
                    done.record(self._side_stream)
        n = len(images_bgr)
        return dev[:n], dict(zip(grids, zip(grids.values(), dev[n:]))), done

    def _to_host(self, rows: torch.Tensor) -> tuple:
        """Queue the copy of ``rows`` to the host: (host tensor, event that
        marks the copy done, None on the CPU)."""
        if not self._on_card():
            return rows, None
        buf = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        buf.copy_(rows, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return buf, done

    def _tile_rows(self, tiles: torch.Tensor, grid_t: torch.Tensor,
                   first: int, ts: int) -> torch.Tensor:
        """Rows [n, max_det, 13] (x1..y4, cls, conf, angle, valid, tile_id)
        of n tiles [n, ts, ts, 3] at origins ``grid_t`` [n, 4], the first
        being tile ``first`` of the scale's batch."""
        cfg = self.cfg
        x = DT.build_multich(tiles, cfg.channels, cfg.dt_edge) / 255.0
        out = self.models[ts](x.to(self.dtype))
        rbox, scores = D.decode_raw(out, ts)
        dets = D.postprocess_batch(
            rbox, scores, self._conf_thr(), cfg.engine_nms_iou,
            max_det=cfg.max_det_per_tile, pre_topk=cfg.pre_topk)
        c8g = T.stitch_to_global(dets["corners8"], grid_t[:, :2])
        valid = dets["valid"]
        margin = float(T.margin_for(ts, cfg.margin_128, cfg.margin_416))
        if cfg.apply_border_filter and margin > 0:
            valid = valid & T.border_keep_mask(G.box_center(c8g), grid_t,
                                               margin)
        ang = torch.where(dets["cls"] == STRIKE_CLS, G.strike_angle(c8g),
                          torch.zeros_like(dets["conf"]))
        tile_id = torch.arange(first, first + len(grid_t),
                               device=self.device)[:, None].expand_as(valid)
        return torch.cat([
            c8g, dets["cls"][..., None].float(), dets["conf"][..., None],
            ang[..., None], valid[..., None].float(),
            tile_id[..., None].float()], dim=-1)

    def _scale_rows(self, maps: list, grids: list, grid_t: torch.Tensor,
                    scale: ScaleConfig) -> tuple:
        """Device part of one scale over the tiles of every map, with no
        host synchronization: fixed-shape rows [T, max_det, 13] and each
        map's (first tile, tile count). The tiles go through the network
        in chunks of at most ``TILE_PIXELS_PER_FORWARD`` pixels, so the
        activations and the NMS stay bounded however many maps come. In a
        data-parallel group each process runs its contiguous share of the
        flat tile list (``tile_id`` stays the global index) and the rows of
        every share are gathered to every process."""
        ts = scale.tile_size
        counts = [len(g) for g in grids]
        starts = np.cumsum([0] + counts)
        segments = list(zip(starts[:-1].tolist(), counts))
        owner = np.repeat(np.arange(len(maps)), counts)
        flat = np.concatenate(grids)
        padded = [T.pad_for_tiles(m, ts) for m in maps]
        per = max(1, TILE_PIXELS_PER_FORWARD // (ts * ts))
        shares = [PM.rank_range(len(flat), r, PD.world())
                  for r in range(PD.world())]
        lo, hi = shares[PD.rank()]
        rows = []
        for a in range(lo, hi, per):
            b = min(a + per, hi)
            own = owner[a:b]
            tiles = torch.cat([
                T.gather_tiles(padded[i], flat[a:b][own == i], ts)
                for i in np.unique(own)])
            rows.append(self._tile_rows(tiles, grid_t[a:b], a, ts))
        if not PD.active():
            return torch.cat(rows), segments
        # this process's share of the tiles, then every process's rows
        mine = torch.cat(rows) if rows else torch.zeros(
            (0, self.cfg.max_det_per_tile, 13), device=self.device)
        return PD.all_gather_rows(mine, [b - a for a, b in shares]), segments

    @torch.inference_mode()
    def _dispatch(self, uploaded: tuple) -> list:
        """Queue every scale's device work over a group of uploaded maps,
        and the copy of its rows to the host, without waiting for the
        device. Returns [(tile_size, host rows, copy event, segments)]."""
        maps, grids, done = uploaded
        with prof.timed("detect/dispatch"):
            if done is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(done)
                for m in [*maps, *(g for _, g in grids.values())]:
                    m.record_stream(compute)
            pending = []
            for sc in self.cfg.scales:
                rows, segments = self._scale_rows(maps, *grids[sc.tile_size],
                                                  sc)
                pending.append((sc.tile_size, *self._to_host(rows),
                                segments))
        return pending

    @staticmethod
    def _fetch(pending: list) -> list:
        """Wait for each scale's rows: [(tile_size, rows [T, max_det, 13]
        float32 numpy, segments)]."""
        with prof.timed("detect/fetch"):
            out = []
            for ts, buf, done, segments in pending:
                if done is not None:
                    done.synchronize()
                out.append((ts, buf.numpy(), segments))
        return out

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

    def _split_and_finalize(self, fetched: list, n_maps: int) -> list:
        """Per map and scale, the valid rows of the map's tiles through the
        per-tile merge, then each map's fusion (``_finalize``)."""
        per_map: list[dict] = [dict() for _ in range(n_maps)]
        for ts, rows, segments in fetched:
            with prof.timed(f"detect/merge_{ts}"):
                for i, (start, count) in enumerate(segments):
                    sub = rows[start:start + count].reshape(-1, rows.shape[-1])
                    sub = sub[sub[:, 11] > 0.5].astype(np.float64)
                    per_map[i][ts] = self._merge_collected(
                        sub, self.cfg.merge_iou)
        with prof.timed("detect/fusion"):
            return [self._finalize(d) for d in per_map]

    def _finalize(self, dets_by_scale: dict) -> dict:
        """The fusion (`Detect_OBB.py:268-345`): {'by_scale': {tile_size:
        [N, 11]}, 'merged_for_pr': the global merge of the cross-scale
        consensus} and, under ``calculate_metrics``, 'merged_for_map': the
        global merge of the union of the scales."""
        result = {"by_scale": dets_by_scale}
        if self.cfg.calculate_metrics:
            union = (np.concatenate(list(dets_by_scale.values()))
                     if dets_by_scale else np.zeros((0, DET_WIDTH)))
            result["merged_for_map"] = F.merge_detections(
                union, self.cfg.merge_iou)
        result["merged_for_pr"] = F.merge_detections(
            F.cross_scale_consensus_filter(dets_by_scale), self.cfg.merge_iou)
        return result

    def detect_images(self, images_bgr: list) -> list:
        """Detection over several maps: one device batch per scale covers
        the tiles of every map, then each map's host merges and fusion.
        Returns one result dict per map, as ``detect_image`` gives."""
        images_bgr = list(images_bgr)
        if not images_bgr:
            return []
        fetched = self._fetch(self._dispatch(self._upload(images_bgr)))
        return self._split_and_finalize(fetched, len(images_bgr))

    def detect_stream(self, images_bgr, chunk: int = 1):
        """Pipelined detection, a generator of per-map result dicts (as
        ``detect_image`` gives) over groups of ``chunk`` maps, in input
        order. Per group k: dispatch k, upload k+1 (beside k's device
        work), fetch k, dispatch k+1, then k's host merges and fusion while
        the device runs k+1. The rows are those of ``detect_images`` over
        each group."""
        images_bgr = list(images_bgr)
        if not images_bgr:
            return
        chunk = max(1, chunk)
        groups = [images_bgr[i:i + chunk]
                  for i in range(0, len(images_bgr), chunk)]
        cur = self._dispatch(self._upload(groups[0]))
        for k, nxt in enumerate(groups[1:]):
            uploaded = self._upload(nxt, side=True)
            fetched = self._fetch(cur)
            cur = self._dispatch(uploaded)
            yield from self._split_and_finalize(fetched, len(groups[k]))
        yield from self._split_and_finalize(self._fetch(cur),
                                            len(groups[-1]))

    def detect_image(self, image_bgr: np.ndarray) -> dict:
        """Every scale, then the fusion (``_finalize``) of one map."""
        return self.detect_images([image_bgr])[0]

    def predict(self, image_bgr: np.ndarray) -> Detections:
        """``detect_image`` behind the ultralytics-Results accessors."""
        return Detections(self.detect_image(image_bgr)["merged_for_pr"])

    @torch.inference_mode()
    def predict_crop(self, crop_bgr: np.ndarray,
                     tile_size: int | None = None) -> Detections:
        """The reference's single-crop predictor (`Detect_OBB.py:76-85`):
        the network input built on the raw crop (DT-Edge at the crop's own
        shape for 4 channels), letterboxed to the model size, one forward,
        decode and the engine's rotated NMS, and the corners mapped back
        to crop pixels by (x - pad) / ratio. No tiling, no border filter,
        no merge: [N, 11] rows of the crop."""
        ts = tile_size or self.cfg.scales[0].tile_size
        if ts not in self.models:
            raise ValueError(f"no model for tile size {ts}; have "
                             f"{sorted(self.models)}")
        cfg = self.cfg
        crop = torch.from_numpy(np.ascontiguousarray(crop_bgr)).to(
            self.device)
        mc = DT.build_multich(crop[None], cfg.channels, cfg.dt_edge)[0]
        x, ratio, (dw, dh) = IM.letterbox(mc.permute(1, 2, 0), ts)
        out = self.models[ts]((x.permute(2, 0, 1)[None] / 255.0).to(
            self.dtype))
        rbox, scores = D.decode_raw(out, ts)
        dets = D.postprocess_batch(
            rbox, scores, self._conf_thr(), cfg.engine_nms_iou,
            max_det=cfg.max_det_per_tile, pre_topk=cfg.pre_topk)
        pad = torch.tensor([dw, dh] * 4, dtype=torch.float32,
                           device=self.device)
        c8 = (dets["corners8"][0] - pad) / ratio
        cls = dets["cls"][0]
        ang = torch.where(cls == STRIKE_CLS, G.strike_angle(c8),
                          torch.zeros_like(dets["conf"][0]))
        rows = torch.cat([c8, cls[:, None].float(),
                          dets["conf"][0][:, None], ang[:, None],
                          dets["valid"][0][:, None].float()], dim=1)
        rows = rows.cpu().numpy().astype(np.float64)
        return Detections(rows[rows[:, 11] > 0.5][:, :DET_WIDTH])


def random_variables(nc: int, model_scale: str, channels: int,
                     seed: int = 0) -> dict:
    """Flax variables of a seeded fresh model (the JAX package's init rule,
    ``train.trainer.fresh_model``, and the engine's head biases), for a
    scale with no checkpoint."""
    from ..train.trainer import fresh_model

    return jax_trees_from_torch_state(
        fresh_model(nc, model_scale, channels, seed).state_dict())


def read_scales(triples, channels: int = 3, model_scale: str = "x",
                allow_random: bool = False) -> tuple:
    """(scales, params_by_scale) for ``(tile_size, overlap, checkpoint)``
    triples, with each checkpoint's ``extra`` read as the JAX package's
    ``cli.py detect`` reads it: a recorded ``channels`` other than
    ``channels`` raises, a recorded ``model_scale`` wins over
    ``model_scale``, a recorded ``tile_size`` other than the scale's warns.
    A scale with no checkpoint warns and gets ``random_variables``; a named
    checkpoint that does not exist raises ``ValueError`` unless
    ``allow_random``, and then warns and gets them too. Duplicate tile
    sizes raise ``ValueError``."""
    scales, params = [], {}
    for ts, ov, ck in triples:
        if ts in params:
            raise ValueError(f"duplicate tile size {ts} in the scales")
        msc = model_scale
        if ck is None or not os.path.exists(ck):
            if ck is None:
                print(f"[WARN] no checkpoint given for scale {ts}; random "
                      f"init")
            elif not allow_random:
                raise ValueError(f"checkpoint {ck} for scale {ts} does not "
                                 f"exist (pass --allow-random to run with "
                                 f"random init anyway)")
            else:
                print(f"[WARN] checkpoint {ck} missing; random init "
                      f"(--allow-random)")
            params[ts] = random_variables(DetectConfig.nc, msc, channels)
            scales.append(ScaleConfig(ts, ov, checkpoint=ck,
                                      model_scale=msc))
            continue
        ckd = load_checkpoint(ck)
        extra = ckd.get("extra", {})
        ck_ch = extra.get("channels")
        if ck_ch is not None and int(ck_ch) != channels:
            raise ValueError(f"checkpoint {ck} was trained with channels="
                             f"{ck_ch} but --channels {channels} was "
                             f"requested")
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
                   device=None, allow_random: bool = False, **cfg_fields
                   ) -> TiledDetector:
    """A detector over ``(tile_size, overlap, checkpoint)`` triples (see
    ``read_scales``); ``cfg_fields`` set other ``DetectConfig`` fields."""
    scales, params = read_scales(triples, channels, model_scale,
                                 allow_random)
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


def write_outputs(image_bgr: np.ndarray, image_path: str, result: dict,
                  output_dir: str, store: dict | None = None) -> None:
    """``{stem}_detected.jpg`` and ``{stem}.xlsx`` of one map's result in
    ``output_dir``, and the rows the metrics need in ``store`` ('pr', and
    'map' under ``calculate_metrics``) (`Detect_OBB.py:293-345`)."""
    import cv2

    merged = result["merged_for_pr"]
    stem = os.path.splitext(os.path.basename(image_path))[0]
    os.makedirs(output_dir, exist_ok=True)
    cv2.imwrite(os.path.join(output_dir, f"{stem}_detected.jpg"),
                draw_detections(image_bgr, merged))
    export_xlsx(os.path.join(output_dir, f"{stem}.xlsx"), merged)
    if store is not None:
        store.setdefault("pr", {})[image_path] = merged
        if "merged_for_map" in result:
            store.setdefault("map", {})[image_path] = result[
                "merged_for_map"]


def process_image(detector: TiledDetector, image_path: str, output_dir: str,
                  store: dict | None = None) -> dict:
    """Detect, draw and export one image (`Detect_OBB.py:268-345`): the
    outputs of ``write_outputs``."""
    import cv2

    t0 = time.time()
    image = cv2.imread(image_path)
    if image is None:
        print(f"[Warn] Could not read image: {image_path}")
        return {}

    result = detector.detect_image(image)
    elapsed = time.time() - t0
    print(f"--- {elapsed:.3f} seconds ---")
    write_outputs(image, image_path, result, output_dir, store)
    result["seconds"] = elapsed
    return result
