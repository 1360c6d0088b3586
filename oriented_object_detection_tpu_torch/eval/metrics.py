"""Evaluation suite (`Detect_OBB.py:456-740`), host work only: greedy-matched
P/R/F1, VOC-style AP and mAP over IoU sweeps, soft mAP, the center-hit
metric and the class-wise report with its xlsx.

Ground truth is loaded once per image and cached, and every det-vs-GT IoU
of an image comes from one exact quad-IoU call (``native/geom.cpp``); the
multi-threshold PR matching runs there too. Detections are [N, 11] rows
(x1..y4, cls, conf, angle); GTs [M, 9] (cls, corners in pixels).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable, Iterable

import numpy as np

from ..config import CLASS_NAMES
from ..data import labels as L
from ..infer.fusion import exact_iou_matrix_host
from ..utils import native
from ..utils.xlsx import write_xlsx


class GTCache:
    """Per-image GT cache with a memoized det-vs-GT IoU matrix.

    ``loader(image_path) -> [M, 9]`` reads an image's ground truth (default:
    its label file scaled by the image's size, which needs cv2). The memo
    key is the det corners' raw bytes, and the memo is a bounded LRU."""

    IOU_CACHE_MAX = 256

    def __init__(self, loader: Callable[[str], np.ndarray] | None = None):
        self.loader = loader or L.load_gt_as_pixels
        self._gt: dict[str, np.ndarray] = {}
        self._iou: "OrderedDict[tuple, np.ndarray]" = OrderedDict()

    def gt(self, image_path: str) -> np.ndarray:
        if image_path not in self._gt:
            self._gt[image_path] = self.loader(image_path)
        return self._gt[image_path]

    def iou(self, dets: np.ndarray, image_path: str) -> np.ndarray:
        """[N_det, N_gt] exact IoU, memoized on (image, det content)."""
        arr = np.ascontiguousarray(
            np.asarray(dets, dtype=np.float64)[:, :8])
        key = (image_path, arr.shape, arr.tobytes())
        hit = self._iou.get(key)
        if hit is not None:
            self._iou.move_to_end(key)
            return hit
        mat = exact_iou_matrix_host(arr, self.gt(image_path)[:, 1:])
        self._iou[key] = mat
        while len(self._iou) > self.IOU_CACHE_MAX:
            self._iou.popitem(last=False)
        return mat


def prec_rec_f1(tp: float, fp: float, fn: float):
    """`Detect_OBB.py:482-486` (1e-9 eps)."""
    P = tp / (tp + fp + 1e-9)
    R = tp / (tp + fn + 1e-9)
    F1 = 2 * P * R / (P + R + 1e-9)
    return P, R, F1


def match_dets_to_gts(dets: np.ndarray, gts: np.ndarray,
                      iou: np.ndarray, iou_thr: float):
    """Greedy in-order matching (`Detect_OBB.py:456-480`): each det takes
    the best-IoU unused same-class GT; TP iff that IoU >= thr."""
    used = np.zeros(len(gts), dtype=bool)
    tp = 0
    for i, det in enumerate(dets):
        cls1 = int(det[8])
        best_iou, best_j = 0.0, -1
        for j in range(len(gts)):
            if used[j] or cls1 != int(gts[j, 0]):
                continue
            if iou[i, j] > best_iou:
                best_iou, best_j = iou[i, j], j
        if best_iou >= iou_thr and best_j >= 0:
            used[best_j] = True
            tp += 1
    fp = len(dets) - tp
    fn = int((~used).sum())
    return tp, fp, fn


def compute_ap_from_pr(recall: np.ndarray, precision: np.ndarray) -> float:
    """Monotone precision envelope + step integration
    (`Detect_OBB.py:489-499`)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def compute_pr_for_class(dets: list, gts: dict, iou_lookup, iou_thr: float):
    """Class PR curve + AP (`Detect_OBB.py:512-565`) at one IoU threshold.

    dets: list of (image_path, det_index, score); gts: {img: [M_c] GT row
    indices}; iou_lookup(img) -> the image's full [N_det, N_gt] matrix.
    Returns (precision, recall, ap, TP, FP, FN)."""
    return compute_pr_for_class_multi(dets, gts, iou_lookup, [iou_thr])[0]


def compute_pr_for_class_multi(dets: list, gts: dict, iou_lookup,
                               iou_list) -> list:
    """`compute_pr_for_class` at every IoU threshold of ``iou_list`` in one
    pass: the matching state is per image, so the global conf-ordered walk
    splits into one native ``pr_match_multi`` call per image (the stable
    global sort keeps each image's relative order), whose TP flags go back
    to their global ranks. Returns (precision, recall, ap, TP, FP, FN) per
    threshold."""
    T = len(iou_list)
    thr = np.asarray(iou_list, dtype=float)
    npos = sum(len(v) for v in gts.values())
    if npos == 0:
        return [(np.array([0.0]), np.array([0.0]), 0.0, 0, 0, 0)] * T
    if not dets:
        return [(np.array([0.0]), np.array([0.0]), 0.0, 0, 0, npos)] * T

    order = sorted(range(len(dets)), key=lambda i: -dets[i][2])
    tp = np.zeros((T, len(dets)))
    by_img: dict = {}
    for rank, di in enumerate(order):
        img, det_idx, _ = dets[di]
        r, d = by_img.setdefault(img, ([], []))
        r.append(rank)
        d.append(det_idx)
    for img, (ranks, didx) in by_img.items():
        rows = np.asarray(gts.get(img, []), dtype=int)
        if not len(rows):
            continue
        block = np.ascontiguousarray(iou_lookup(img)[np.ix_(didx, rows)])
        tp[:, ranks] = native.pr_match_multi(block, thr)
    return _pr_curves_from_tp(tp, npos, T)


def _pr_curves_from_tp(tp: np.ndarray, npos: int, T: int) -> list:
    out = []
    for t in range(T):
        tp_c = np.cumsum(tp[t])
        fp_c = np.cumsum(1.0 - tp[t])
        recall = tp_c / (npos + 1e-9)
        precision = tp_c / (tp_c + fp_c + 1e-9)
        ap = compute_ap_from_pr(recall, precision)
        out.append((precision, recall, ap, int(tp_c[-1]), int(fp_c[-1]),
                    npos - int(tp_c[-1])))
    return out


def _dets_of(dets_per_image: dict, img: str) -> np.ndarray:
    return np.asarray(dets_per_image.get(img, np.zeros((0, 11)))
                      ).reshape(-1, 11)


def evaluate_map(dets_per_image: dict, all_images: Iterable[str],
                 iou_list, cache: GTCache,
                 map_min_score: float = 0.001) -> dict:
    """mAP over an IoU threshold list (`Detect_OBB.py:574-607`): per IoU,
    the mean AP over the classes present in the GT; 'mAP@0.5' is the 0.5
    entry, 'mAP@mean' the mean over the list."""
    all_images = list(all_images)
    class_ids = sorted({
        int(c) for img in all_images for c in cache.gt(img)[:, 0]})
    arrs = {img: _dets_of(dets_per_image, img) for img in all_images}
    # per-class det and GT lists in image order, then ascending det index,
    # as the reference's nested loops build them
    per_class_dets: dict[int, list] = {cid: [] for cid in class_ids}
    per_class_gts: dict[int, dict] = {cid: {} for cid in class_ids}
    for img in all_images:
        arr = arrs[img]
        cls_col = arr[:, 8].astype(int)
        score = arr[:, 9]
        gcls = cache.gt(img)[:, 0].astype(int)
        for cid in class_ids:
            sel = np.where((cls_col == cid) & (score >= map_min_score))[0]
            per_class_dets[cid].extend(
                (img, int(i), float(score[i])) for i in sel)
            per_class_gts[cid][img] = [
                int(j) for j in np.where(gcls == cid)[0]]

    def lookup(img):
        return cache.iou(arrs[img], img)

    aps_by_iou = [[] for _ in iou_list]
    for cid in class_ids:
        per_thr = compute_pr_for_class_multi(
            per_class_dets[cid], per_class_gts[cid], lookup, iou_list)
        for t, (_, _, ap, *_rest) in enumerate(per_thr):
            aps_by_iou[t].append(ap)
    per_iou = {
        round(float(iou_thr), 2): (float(np.mean(aps_by_iou[t]))
                                   if aps_by_iou[t] else 0.0)
        for t, iou_thr in enumerate(iou_list)
    }
    ious = [round(float(i), 2) for i in iou_list]
    return {
        "mAP@0.5": per_iou.get(0.5, 0.0),
        "mAP@mean": float(np.mean([per_iou[i] for i in ious]))
        if ious else 0.0,
        "per_iou": per_iou,
    }


def _point_in_quad(pt: np.ndarray, c8: np.ndarray) -> np.ndarray:
    """True iff the point [..., 2] lies strictly inside the quad [..., 8]
    (ray crossing; boundary points excluded, as shapely's ``contains``)."""
    pt = np.asarray(pt, np.float64)
    pts = np.asarray(c8, np.float64).reshape(*np.shape(c8)[:-1], 4, 2)
    x, y = pt[..., 0], pt[..., 1]
    inside = np.zeros(np.broadcast_shapes(x.shape, pts.shape[:-2]), bool)
    on_edge = np.zeros_like(inside)
    for i in range(4):
        x1, y1 = pts[..., i, 0], pts[..., i, 1]
        x2, y2 = pts[..., (i + 1) % 4, 0], pts[..., (i + 1) % 4, 1]
        cond = (y1 > y) != (y2 > y)
        xint = (x2 - x1) * (y - y1) / np.where(y2 == y1, 1.0, y2 - y1) + x1
        inside = np.where(cond & (x < xint), ~inside, inside)
        cr = (x2 - x1) * (y - y1) - (y2 - y1) * (x - x1)
        within = (np.minimum(x1, x2) <= x) & (x <= np.maximum(x1, x2)) & (
            np.minimum(y1, y2) <= y) & (y <= np.maximum(y1, y2))
        on_edge = on_edge | ((cr == 0) & within)
    return inside & ~on_edge


def _quad_is_simple(c8: np.ndarray) -> np.ndarray:
    """False for a self-intersecting (bow-tie) quad [..., 8]."""
    pts = np.asarray(c8, np.float64).reshape(*np.shape(c8)[:-1], 4, 2)

    def cross(o, a, b):
        return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
            a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0])

    def proper(p1, p2, p3, p4):
        d1, d2 = cross(p3, p4, p1), cross(p3, p4, p2)
        d3, d4 = cross(p1, p2, p3), cross(p1, p2, p4)
        return (d1 * d2 < 0) & (d3 * d4 < 0)

    return ~(proper(pts[..., 0, :], pts[..., 1, :], pts[..., 2, :],
                    pts[..., 3, :])
             | proper(pts[..., 1, :], pts[..., 2, :], pts[..., 3, :],
                      pts[..., 0, :]))


def evaluate_center_hit(dets_per_image: dict, all_images: Iterable[str],
                        cache: GTCache, conf_thr: float = 0.5):
    """Center-hit metric (`Detect_OBB.py:609-648`): TP iff a det's center
    (conf >= thr) lies strictly inside the first unused, simple,
    same-class GT polygon in file order."""
    tp = fp = fn = 0
    for img in all_images:
        arr = _dets_of(dets_per_image, img)
        dets = arr[arr[:, 9] >= conf_thr]
        gts = cache.gt(img)
        used = np.zeros(len(gts), dtype=bool)
        if len(dets) and len(gts):
            centers = np.stack([dets[:, 0:8:2].mean(1),
                                dets[:, 1:8:2].mean(1)], axis=1)
            inside = _point_in_quad(centers[:, None, :], gts[None, :, 1:])
            simple = _quad_is_simple(gts[:, 1:])
        else:
            inside = np.zeros((len(dets), len(gts)), bool)
            simple = np.ones(len(gts), bool)
        gcls = gts[:, 0].astype(int) if len(gts) else np.zeros(0, int)
        det_cls = dets[:, 8].astype(int)
        for i in range(len(dets)):
            cand = inside[i] & ~used & simple & (gcls == det_cls[i])
            if cand.any():
                used[int(np.argmax(cand))] = True
                tp += 1
            else:
                fp += 1
        fn += int((~used).sum())

    P, R, F1 = prec_rec_f1(tp, fp, fn)
    print(f"[Center-Hit @ conf≥{conf_thr:.2f}] P={P:.3f} R={R:.3f} "
          f"F1={F1:.3f} (TP={tp}, FP={fp}, FN={fn})")
    return P, R, F1


def evaluate_dataset(dets_per_image: dict, all_images: Iterable[str],
                     cache: GTCache, conf_thr: float, iou_thr: float):
    """Dataset-level P/R/F1 (`Detect_OBB.py:650-658`)."""
    tot = np.zeros(3, dtype=np.int64)
    for img in all_images:
        arr = _dets_of(dets_per_image, img)
        filt_idx = np.where(arr[:, 9] >= conf_thr)[0]
        iou_full = cache.iou(arr, img)
        tot += match_dets_to_gts(arr[filt_idx], cache.gt(img),
                                 iou_full[filt_idx], iou_thr)
    return prec_rec_f1(*tot)


def classwise_report(dets_per_image: dict, all_images: Iterable[str],
                     cache: GTCache, conf_thr: float, iou_thr: float,
                     out_path: str | None = None):
    """Per-class TP/FP/FN/P/R/F1 rows and their xlsx
    (`Detect_OBB.py:660-686`)."""
    all_cids = sorted({
        int(d[8]) for dets in dets_per_image.values()
        for d in np.asarray(dets).reshape(-1, 11)})
    rows = []
    for cid in all_cids:
        tot = np.zeros(3, dtype=np.int64)
        for img in all_images:
            arr = _dets_of(dets_per_image, img)
            sel = np.where((arr[:, 8].astype(int) == cid)
                           & (arr[:, 9] >= conf_thr))[0]
            gts = cache.gt(img)
            gsel = gts[:, 0].astype(int) == cid
            iou_full = cache.iou(arr, img)
            tot += match_dets_to_gts(
                arr[sel], gts[gsel],
                iou_full[np.ix_(sel, np.where(gsel)[0])], iou_thr)
        P, R, F1 = prec_rec_f1(*tot)
        rows.append([cid, CLASS_NAMES.get(cid, str(cid)),
                     int(tot[0]), int(tot[1]), int(tot[2]), P, R, F1])
    if out_path:
        write_xlsx(out_path, rows, header=[
            "cls_id", "class", "TP", "FP", "FN",
            "Precision", "Recall", "F1"])
        print(f"[Saved] {out_path}")
    return rows


def run_fusion_eval(dets_pr: dict, input_dir: str, output_dir: str,
                    iou_thr: float = 0.25, dets_map: dict | None = None,
                    cache: GTCache | None = None,
                    single_scale: bool = False,
                    map_min_score: float = 0.001) -> dict:
    """The evaluation block (`Detect_OBB.py:688-740`) over the images of
    ``input_dir``: P/R/F1 at conf = iou_thr (the reference sets the conf
    threshold to the IoU threshold's value, `:700-702`), the class-wise
    xlsx, center-hit, mAP@0.5 and mAP@[0.5:0.95] and the soft mAP@0.3 and
    mAP@[0.3:0.7]."""
    cache = cache or GTCache()
    all_images = sorted(
        os.path.join(input_dir, f) for f in os.listdir(input_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".tif", ".tiff")))
    if not all_images:
        print("[Eval] No images found for evaluation.")
        return {}

    thr = float(iou_thr)
    tag = "Report" if single_scale else "Fusion"
    if not single_scale:
        print("[Fusion] scale-agnostic merge (late fusion).")
    P, R, F1 = evaluate_dataset(dets_pr, all_images, cache,
                                conf_thr=thr, iou_thr=iou_thr)
    print(f"[{tag} @ {thr:.2f}] Precision={P:.3f} | Recall={R:.3f} "
          f"| F1={F1:.3f}")

    classwise_report(
        dets_pr, all_images, cache, conf_thr=thr, iou_thr=iou_thr,
        out_path=os.path.join(output_dir, "fusion_classwise_metrics.xlsx"))
    ch = evaluate_center_hit(dets_pr, all_images, cache, conf_thr=thr)

    # the wide (pre-consensus) set feeds mAP when there is one (`:583`)
    map_source = dets_map if dets_map is not None else dets_pr
    maps = evaluate_map(map_source, all_images,
                        list(np.arange(0.5, 0.96, 0.05)), cache,
                        map_min_score=map_min_score)
    print("[mAP Results]")
    print(f"mAP@0.5 = {maps['mAP@0.5']:.4f}")
    print(f"mAP@[0.5:0.95] = {maps['mAP@mean']:.4f}")

    soft = evaluate_map(map_source, all_images,
                        [0.30, 0.40, 0.50, 0.60, 0.70], cache,
                        map_min_score=map_min_score)
    print("[mAP (soft) Results]")
    print(f"mAP@0.3 = {soft['per_iou'][0.3]:.4f}")
    print(f"mAP@[0.3:0.7] = {soft['mAP@mean']:.4f}")

    return {
        "precision": P, "recall": R, "f1": F1,
        "center_hit": ch,
        "mAP@0.5": maps["mAP@0.5"],
        "mAP@[0.5:0.95]": maps["mAP@mean"],
        "soft_mAP@0.3": soft["per_iou"][0.3],
        "soft_mAP@[0.3:0.7]": soft["mAP@mean"],
    }
