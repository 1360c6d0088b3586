"""The comparisons that decide ``correct``: the numbers each cell compares
between what its timed path produced and the plain reference, each held
to a limit in the cell's file (``limits``).

Detection pairs rows one by one: a row of confidence >= ``STRONG`` on
either side needs a row of the same class on the other side, of
confidence >= ``WEAK`` and within ``PAIR_DCONF`` of its own, at exact
quad IoU >= ``PAIR_IOU``. Training
compares norms leaf by leaf, each gap measured against the reference's
norm of that leaf or of the median leaf, whichever is larger.
"""

from __future__ import annotations

import numpy as np

from ..reference import merge

STRONG, WEAK, PAIR_IOU, PAIR_DCONF = 0.4, 0.2, 0.5, 0.05


def _partner(row, rows, boxes) -> int:
    """Index of the best-IoU same-class partner of ``row`` in ``rows``
    (IoU >= PAIR_IOU, confidence within PAIR_DCONF), or -1."""
    x, y = row[0:8:2], row[1:8:2]
    cand = np.nonzero((rows[:, 8] == row[8])
                      & (np.abs(rows[:, 9] - row[9]) <= PAIR_DCONF)
                      & (boxes[:, 0] <= x.max())
                      & (x.min() <= boxes[:, 2]) & (boxes[:, 1] <= y.max())
                      & (y.min() <= boxes[:, 3]))[0]
    best, best_iou = -1, PAIR_IOU
    for j in cand:
        iou = merge.quad_iou(row, rows[j])
        if iou >= best_iou:
            best, best_iou = j, iou
    return best


def pair_rows(got: np.ndarray, ref: np.ndarray) -> dict:
    """Pairing of program rows ``got`` against reference rows ``ref``
    ([N, 11] each): the strong rows on both sides, how many found no
    partner, and the confidence gaps of the reference's strong rows to
    their partners."""
    got = np.asarray(got, np.float64).reshape(-1, 11)
    ref = np.asarray(ref, np.float64).reshape(-1, 11)
    out = {"strong": 0, "unpaired": 0, "conf_gaps": []}
    for a, b, keep in ((ref, got, True), (got, ref, False)):
        weak = b[b[:, 9] >= WEAK]
        boxes = merge._aabb(weak) if len(weak) else np.zeros((0, 4))
        for row in a[a[:, 9] >= STRONG]:
            out["strong"] += 1
            j = _partner(row, weak, boxes) if len(weak) else -1
            if j < 0:
                out["unpaired"] += 1
            elif keep:
                out["conf_gaps"].append(abs(row[9] - weak[j, 9]))
    return out


def detection_readings(got: list, ref: list) -> dict:
    """Over the sampled maps (program results ``got``, reference results
    ``ref``), each map's ``by_scale`` rows and ``merged_for_pr``: the share
    of all their strong rows without a partner (``unpaired_share``), and
    the largest mean confidence gap of one output's paired rows
    (``conf_gap_mean``)."""
    worst = {"conf_gap_mean": 0.0}
    counts = []
    for g, r in zip(got, ref):
        outs = [(f"by_scale_{ts}", g["by_scale"].get(ts, np.zeros((0, 11))),
                 r["by_scale"][ts]) for ts in r["by_scale"]]
        outs.append(("merged_for_pr", g["merged_for_pr"], r["merged_for_pr"]))
        for name, a, b in outs:
            p = pair_rows(a, b)
            if p["conf_gaps"]:
                worst["conf_gap_mean"] = max(worst["conf_gap_mean"],
                                             float(np.mean(p["conf_gaps"])))
            counts.append((name, p["strong"], p["unpaired"]))
    strong = sum(c[1] for c in counts)
    worst["unpaired_share"] = (sum(c[2] for c in counts) / strong
                               if strong else 0.0)
    worst["strong_rows"] = int(strong)
    return worst


def leaf_gaps(got: np.ndarray, ref: np.ndarray, keep=None) -> np.ndarray:
    """|got_i - ref_i| / max(ref_i, median ref) for each leaf i (of those
    where ``keep``)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if keep is not None:
        got, ref = got[keep], ref[keep]
    if not len(ref):
        return np.zeros(1)
    den = np.maximum(ref, np.median(ref))
    return np.abs(got - ref) / np.where(den > 0, den, 1.0)


def training_readings(got: dict, ref: dict) -> dict:
    """``got`` and ``ref`` hold 'losses' (the first three steps), and per
    leaf 'grad' (the first step's gradient norm), 'change' (the norm of
    the parameters' change over three steps) and 'ema_change' (the EMA's).
    The changes leave out leaves whose reference gradient is under a
    thousandth of the median leaf's: round-off alone moves them."""
    lg, lr = np.asarray(got["losses"]), np.asarray(ref["losses"])
    g_ref = np.asarray(ref["grad"])
    moving = g_ref >= 1e-3 * np.median(g_ref)
    gaps = {"grad": leaf_gaps(got["grad"], g_ref),
            "change": leaf_gaps(got["change"], ref["change"], moving),
            "ema": leaf_gaps(got["ema_change"], ref["ema_change"], moving)}
    out = {"loss_gap": float(np.max(np.abs(lg - lr) / np.abs(lr))),
           "loss_gap_first": float(abs(lg[0] - lr[0]) / abs(lr[0]))}
    for k, v in gaps.items():
        out[f"{k}_gap"] = float(v.max())
        out[f"{k}_gap_median"] = float(np.median(v))
    out["leaves_left_out"] = int((~moving).sum())
    return out
