"""Training artifacts of the run directory, the port of the JAX package's
``utils/plots.py``: ``results.csv`` (always), ``results.png``,
``args.yaml`` and ``train_batch0.jpg`` (the reference trains with
``plots=True``, `Train_OBB.py:811, 839`). matplotlib, yaml and cv2 are
imported inside the functions; a plot that cannot be made is skipped, as
the engine does, and never stops training."""

from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np


class ResultsWriter:
    FIELDS = ["epoch", "loss", "box", "cls", "dfl", "fitness", "lr"]

    def __init__(self, run_dir: str, plots: bool = True):
        self.run_dir = run_dir
        self.plots = plots
        self.rows: list[dict] = []
        os.makedirs(run_dir, exist_ok=True)
        self.csv_path = os.path.join(run_dir, "results.csv")

    def append(self, **kw):
        row = {k: kw.get(k, "") for k in self.FIELDS}
        self.rows.append(row)
        write_header = not os.path.exists(self.csv_path)
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.FIELDS)
            if write_header:
                w.writeheader()
            w.writerow(row)
        if self.plots:
            self._plot()

    def _plot(self):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        if len(self.rows) < 2:
            return
        ep = [r["epoch"] for r in self.rows]
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        for key in ("box", "cls", "dfl"):
            vals = [float(r[key]) for r in self.rows if r[key] != ""]
            if vals:
                axes[0].plot(ep[: len(vals)], vals, label=key)
        axes[0].set_xlabel("epoch")
        axes[0].set_title("train losses")
        axes[0].legend()
        fit = [float(r["fitness"]) for r in self.rows if r["fitness"] != ""]
        if fit:
            axes[1].plot(ep[: len(fit)], fit)
        axes[1].set_xlabel("epoch")
        axes[1].set_title("fitness (0.1*mAP50 + 0.9*mAP50-95)")
        fig.tight_layout()
        fig.savefig(os.path.join(self.run_dir, "results.png"), dpi=100)
        plt.close(fig)


def write_args_yaml(run_dir: str, cfg) -> None:
    """The resolved train arguments as ``args.yaml`` (the engine's run-dir
    artifact); skipped without yaml."""
    try:
        import yaml
    except ImportError:
        return
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "args.yaml"), "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=True)


def _xywhr_corners_np(b) -> np.ndarray:
    cx, cy, w, h, r = [float(v) for v in b]
    c, s = np.cos(r), np.sin(r)
    return np.asarray([(cx + dx * c - dy * s, cy + dx * s + dy * c)
                       for dx, dy in ((w / 2, h / 2), (-w / 2, h / 2),
                                      (-w / 2, -h / 2), (w / 2, -h / 2))],
                      np.float64)


def plot_train_batch(batch: dict, path: str, max_tiles: int = 16) -> None:
    """``train_batch0.jpg``: a grid of the batch's first tiles with their
    rotated GT boxes. Warns and goes on if it fails: a cosmetic artifact
    must not stop a training run."""
    try:
        _plot_train_batch(batch, path, max_tiles)
    except Exception as e:  # warn and continue, the engine's plots semantics
        print(f"[Plots] train_batch plot failed (continuing): {e}")


def _plot_train_batch(batch: dict, path: str, max_tiles: int) -> None:
    try:
        import cv2
    except ImportError:
        return
    # NCHW float 0..1 tensors -> NHWC host arrays
    imgs = batch["images"].detach().permute(0, 2, 3, 1).float().cpu().numpy()
    boxes = batch["gt_xywhr"].detach().cpu().numpy()
    mask = batch["gt_mask"].detach().cpu().numpy().astype(bool)
    n = min(max_tiles, imgs.shape[0])
    side = int(np.ceil(np.sqrt(n)))
    ts = imgs.shape[1]
    canvas = np.zeros((side * ts, side * ts, 3), np.uint8)
    for k in range(n):
        tile = np.ascontiguousarray(
            np.clip(imgs[k][..., :3] * 255.0, 0, 255).astype(np.uint8))
        for b, m in zip(boxes[k], mask[k]):
            if m:
                pts = _xywhr_corners_np(b).round().astype(np.int32)
                cv2.polylines(tile, [pts.reshape(-1, 1, 2)], True,
                              (0, 255, 0), 1)
        r, c = divmod(k, side)
        canvas[r * ts:(r + 1) * ts, c * ts:(c + 1) * ts] = tile
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, canvas)
