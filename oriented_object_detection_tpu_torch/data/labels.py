"""YOLO-OBB label files for evaluation (host side): the 9-column reader,
the label lookup beside an image and the ground truth in pixels
(`Train_OBB.py:228-261`, `Detect_OBB.py:425-454`)."""

from __future__ import annotations

import os

import numpy as np


def read_labels(label_path: str, img_w: int | None = None,
                img_h: int | None = None, strict: bool = False) -> np.ndarray:
    """[N, 9] float64 (cls, x1..y4), normalized unless img_w/img_h are
    given (then x/y are in pixels); an empty [0, 9] on any problem.

    strict=False is the train-side reader (`Train_OBB.py:228-261`): '#'
    comments honored, rows of more than 9 fields cut to 9, shorter rows
    skipped. strict=True is the eval GT parser (`Detect_OBB.py:436-454`): a
    line must have exactly 9 whitespace fields (no comment stripping)."""
    empty = np.zeros((0, 9), dtype=np.float64)
    if (not os.path.exists(label_path)
            or os.path.getsize(label_path) == 0):
        return empty
    rows = []
    try:
        with open(label_path, "r") as f:
            for line in f:
                if not strict:
                    line = line.split("#", 1)[0]
                line = line.strip()
                if not line:
                    continue
                parts = line.split()
                if (len(parts) != 9) if strict else (len(parts) < 9):
                    continue
                try:
                    vals = [float(p) for p in parts[:9]]
                except ValueError:
                    continue
                rows.append(vals)
    except OSError:
        return empty
    if not rows:
        return empty
    out = np.asarray(rows, dtype=np.float64)
    if img_w is not None:
        out[:, 1::2] *= float(img_w)
        out[:, 2::2] *= float(img_h)
    return out


def label_path_for_image(image_path: str) -> str | None:
    """The label file next to the image or in a Labels/ subdirectory
    (`Detect_OBB.py:425-434`), or None."""
    base = os.path.splitext(os.path.basename(image_path))[0] + ".txt"
    for cand in (os.path.join(os.path.dirname(image_path), base),
                 os.path.join(os.path.dirname(image_path), "Labels", base)):
        if os.path.exists(cand):
            return cand
    return None


def load_gt_as_pixels(image_path: str) -> np.ndarray:
    """Ground truth for evaluation: [N, 9] (cls, corners in pixels) scaled
    by the image's own size (`Detect_OBB.py:436-454`); reads the image
    with cv2."""
    import cv2

    lp = label_path_for_image(image_path)
    if lp is None:
        return np.zeros((0, 9), dtype=np.float64)
    img = cv2.imread(image_path)
    if img is None:
        return np.zeros((0, 9), dtype=np.float64)
    h, w = img.shape[:2]
    return read_labels(lp, img_w=w, img_h=h, strict=True)
