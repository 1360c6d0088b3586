"""Global merge and cross-scale consensus late fusion, on the host.

* `merge_detections` (`Detect_OBB.py:176-200`): confidence-descending greedy
  class-aware suppression at exact polygon IoU >= threshold, output in
  confidence-descending order.
* `cross_scale_consensus_filter` (`Detect_OBB.py:347-423`): drop detections
  below CONS_LOW, then pair each unvisited detection with its best
  same-class partner in the other scales (highest confidence, ties broken by
  IoU, partner IoU >= CONS_IOU_PARTNER); keep the stronger of the pair, or a
  solo detection only when its confidence >= CONS_HIGH.

Both run in the native library (``csrc/fusion_grid.cpp`` over
``native/geom.cpp``'s geometry), which raises when it cannot be built.
Each indexes its rows by a uniform grid, so a row tests only the rows that
share a grid cell with its axis-aligned bounding box; the kept rows are
those of the all-pairs scan, in the same order. ``GRID`` counts the calls,
their rows, the pairs tested (``pairs_tested``) and the pairs the
all-pairs scan would test (``pairs_all``). Detections are [N, 11] float64
rows (x1..y4, cls_id, conf, angle).
"""

from __future__ import annotations

import numpy as np

from ..utils import native

CONS_IOU_PARTNER = 0.40
CONS_LOW = 0.25
CONS_HIGH = 0.70

DET_WIDTH = 11  # x1..y4 (8), cls, conf, angle

GRID = {"calls": 0, "rows": 0, "pairs_tested": 0, "pairs_all": 0}


def _count(rows: int, tested: int, scanned: int) -> None:
    GRID["calls"] += 1
    GRID["rows"] += rows
    GRID["pairs_tested"] += tested
    GRID["pairs_all"] += scanned


def exact_iou_matrix_host(c8a: np.ndarray, c8b: np.ndarray) -> np.ndarray:
    """Exact pairwise quad IoU [na, nb] in double precision."""
    return native.quad_iou_matrix(c8a, c8b)


def merge_detections(dets: np.ndarray, iou_threshold: float = 0.4
                     ) -> np.ndarray:
    """Greedy class-aware exact-IoU merge; kept rows in conf-descending
    order (ties keep input order)."""
    dets = np.asarray(dets, np.float64).reshape(-1, DET_WIDTH)
    if not len(dets):
        return dets
    keep, tested, scanned = native.greedy_nms_grid(dets, iou_threshold)
    _count(len(dets), tested, scanned)
    return dets[keep]


def cross_scale_consensus_filter(dets_by_scale: dict) -> np.ndarray:
    """Dual/multi-scale consensus late fusion over {tile_size: [N, 11]};
    kept rows in discovery order. One scale passes through unchanged."""
    scales = sorted(dets_by_scale)
    arrs = [np.asarray(dets_by_scale[s], np.float64).reshape(-1, DET_WIDTH)
            for s in scales]
    if len(arrs) == 1:
        return arrs[0]
    filt = [a[a[:, 9] >= CONS_LOW] for a in arrs]
    rows = np.concatenate(filt) if filt else np.zeros((0, DET_WIDTH))
    scale_of = np.concatenate([np.full(len(f), i, np.int32)
                               for i, f in enumerate(filt)]) \
        if filt else np.zeros(0, np.int32)
    keep, tested, scanned = native.consensus_filter_grid(
        rows, scale_of, CONS_IOU_PARTNER, CONS_LOW, CONS_HIGH)
    _count(len(rows), tested, scanned)
    return rows[keep]
