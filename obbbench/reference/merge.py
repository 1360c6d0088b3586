"""Host merges of the plain reference in Python and numpy, double precision:
the exact quad IoU (quads split into triangles, Sutherland-Hodgman
clipping, a self-intersecting quad has IoU 0), the greedy class-aware
merge and the cross-scale consensus fusion (`Detect_OBB.py:176-200,
347-423`). Rows are [N, 11]: x1..y4, cls, conf, angle.

A greedy merge keeps or drops a row by the rows of higher confidence
alone, so the merge of the rows above a confidence floor is the floor's
part of the merge of every row; the reference runs on those rows only.
"""

from __future__ import annotations

import numpy as np

CONS_IOU_PARTNER, CONS_LOW, CONS_HIGH = 0.40, 0.25, 0.70


def _cross(o, a, b):
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])


def _area(p):
    s = 0.0
    for i in range(len(p)):
        a, b = p[i], p[(i + 1) % len(p)]
        s += a[0] * b[1] - b[0] * a[1]
    return abs(s) * 0.5


def _clip(pts, a, b):
    out = []
    abx, aby = b[0] - a[0], b[1] - a[1]
    for i in range(len(pts)):
        s, e = pts[i], pts[(i + 1) % len(pts)]
        ds = abx * (s[1] - a[1]) - aby * (s[0] - a[0])
        de = abx * (e[1] - a[1]) - aby * (e[0] - a[0])
        if (ds >= 0.0) != (de >= 0.0):
            den = ds - de
            t = 0.0 if abs(den) < 1e-300 else ds / den
            t = min(1.0, max(0.0, t))
            out.append((s[0] + t * (e[0] - s[0]), s[1] + t * (e[1] - s[1])))
        if de >= 0.0:
            out.append(e)
    return out


def _tri_tri(t1, t2):
    if _cross(*t1) < 0:
        t1 = [t1[2], t1[1], t1[0]]
    if _cross(*t2) < 0:
        t2 = [t2[2], t2[1], t2[0]]
    p = list(t1)
    for k in range(3):
        p = _clip(p, t2[k], t2[(k + 1) % 3])
        if not p:
            return 0.0
    return _area(p)


def _triangles(q):
    if _cross(q[0], q[1], q[2]) * _cross(q[0], q[2], q[3]) >= 0.0:
        return [[q[0], q[1], q[2]], [q[0], q[2], q[3]]]
    return [[q[1], q[2], q[3]], [q[1], q[3], q[0]]]


def _proper(p1, p2, p3, p4):
    return (_cross(p3, p4, p1) * _cross(p3, p4, p2) < 0
            and _cross(p1, p2, p3) * _cross(p1, p2, p4) < 0)


def _simple(q):
    return not (_proper(q[0], q[1], q[2], q[3]) or _proper(q[1], q[2], q[3], q[0]))


def quad_iou(c8a, c8b) -> float:
    qa = [(float(c8a[2 * i]), float(c8a[2 * i + 1])) for i in range(4)]
    qb = [(float(c8b[2 * i]), float(c8b[2 * i + 1])) for i in range(4)]
    if not (_simple(qa) and _simple(qb)):
        return 0.0
    inter = sum(_tri_tri(ta, tb) for ta in _triangles(qa)
                for tb in _triangles(qb))
    u = _area(qa) + _area(qb) - inter
    return inter / u if u > 0.0 else 0.0


def _aabb(rows):
    x, y = rows[:, 0:8:2], rows[:, 1:8:2]
    return np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], 1)


def _overlapping(box, boxes):
    return ((box[0] <= boxes[:, 2]) & (boxes[:, 0] <= box[2])
            & (box[1] <= boxes[:, 3]) & (boxes[:, 1] <= box[3]))


def greedy_merge(rows: np.ndarray, iou_thr: float) -> np.ndarray:
    """Confidence-descending (stable) greedy class-aware merge at exact IoU
    >= ``iou_thr``; the kept rows in that order."""
    rows = np.asarray(rows, np.float64).reshape(-1, 11)
    order = np.argsort(-rows[:, 9], kind="stable")
    rows = rows[order]
    boxes = _aabb(rows)
    kept: list[int] = []
    for i in range(len(rows)):
        if kept:
            k = np.asarray(kept)
            cand = k[(rows[k, 8] == rows[i, 8]) & _overlapping(boxes[i],
                                                               boxes[k])]
            if any(quad_iou(rows[i], rows[j]) >= iou_thr for j in cand):
                continue
        kept.append(i)
    return rows[kept]


def consensus(by_scale: dict) -> np.ndarray:
    """Cross-scale consensus over {tile_size: rows}: rows below CONS_LOW go;
    each unvisited row pairs with its best same-class partner in the other
    scales (highest conf, ties by IoU, IoU >= CONS_IOU_PARTNER) and the
    stronger of the pair stays; a row with no partner stays only at conf
    >= CONS_HIGH. One scale passes through."""
    scales = sorted(by_scale)
    arrs = [np.asarray(by_scale[s], np.float64).reshape(-1, 11)
            for s in scales]
    if len(arrs) == 1:
        return arrs[0]
    filt = [a[a[:, 9] >= CONS_LOW] for a in arrs]
    rows = np.concatenate(filt)
    scale_of = np.concatenate([np.full(len(f), i) for i, f in enumerate(filt)])
    boxes = _aabb(rows)
    visited = np.zeros(len(rows), bool)
    keep = []
    for i in range(len(rows)):
        if visited[i]:
            continue
        cand = np.nonzero((scale_of != scale_of[i]) & ~visited
                          & (rows[:, 8] == rows[i, 8])
                          & _overlapping(boxes[i], boxes))[0]
        best, best_conf, best_iou = -1, -1.0, 0.0
        for k in cand:
            iou = quad_iou(rows[i], rows[k])
            if iou >= CONS_IOU_PARTNER:
                cp = rows[k, 9]
                if cp > best_conf or (cp == best_conf and iou > best_iou):
                    best, best_conf, best_iou = k, cp, iou
        visited[i] = True
        if best < 0 or best_conf < CONS_LOW:
            if rows[i, 9] >= CONS_HIGH:
                keep.append(i)
            continue
        keep.append(i if rows[i, 9] >= best_conf else best)
        visited[best] = True
    return rows[keep]
